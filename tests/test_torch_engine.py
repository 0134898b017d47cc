"""The port's serving path (``repro_torch.serving.engine`` and the router)
against the JAX engine, and the port's own engine contracts.

* ``generate`` tokens (tie-aware), u, h_mean and v_mean against
  ``repro.serving.engine.InferenceEngine.generate`` on converted weights,
  for both uncertainty modes;
* in the port: ``generate == generate_stepwise`` and ``serve == generate``
  per request, with a stop token;
* ``route`` / ``charge_batch`` decisions against the JAX ones;
* ``InferenceEngine()`` without ``device`` refuses to run on the CPU;
* importing the port leaves ``jax`` and ``repro`` out of ``sys.modules``.

Tie-aware (as tests/test_continuation.py): tokens agree up to the first
mismatch, and there the reference's top-2 logit gap lies inside the budget.
The bf16 budget is 0.01 on logits of size ~1: both engines round the
activations to bf16 at the same sites, but the port's attention keeps q, k,
v and p in f32 (like the Pallas kernels) where the JAX CPU path rounds them
to bf16.
"""

import copy
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
from repro_torch.convert import from_jax_params
from repro_torch.core import budget as TB
from repro_torch.core import router as TR
from repro_torch.core import uncertainty as TUN
from repro_torch.core.uncertainty import UncertaintyConfig as TU
from repro_torch.models import transformer as TT
from repro_torch.serving.engine import InferenceEngine as TEngine
from repro_torch.serving.faults import FaultPlan
from repro_torch.serving.scheduler import Request

try:        # the JAX reference; a CUDA machine without JAX runs -m gpu only
    import jax
    import jax.numpy as jnp

    from repro import configs as C
    from repro.core import budget as JB
    from repro.core import router as JR
    from repro.core import uncertainty as JUN
    from repro.core.uncertainty import UncertaintyConfig as JU
    from repro.models import transformer as T
    from repro.serving.engine import InferenceEngine as JEngine
except ImportError:
    jax = None

ROOT = Path(__file__).resolve().parents[1]
PROMPTS = np.array([[0, 0, 0, 3, 20, 195, 2],       # left-padded with PAD=0
                    [0, 0, 3, 21, 196, 199, 2],
                    [0, 0, 0, 0, 7, 9, 2],
                    [5, 6, 7, 8, 9, 10, 11]], np.int32)
MAX_NEW = 8


def assert_greedy_match_modulo_ties(out, ref, atol: float = 0.01):
    """``out`` tokens equal ``ref`` up to the first mismatch; there the
    reference's top-2 logit gap is within 2 * atol."""
    to, tr = out["tokens"], ref["tokens"]
    lo, lr = np.asarray(out["logits"]), np.asarray(ref["logits"])
    for b in range(to.shape[0]):
        mism = np.where(to[b] != tr[b])[0]
        n = mism[0] if len(mism) else to.shape[1]
        np.testing.assert_array_equal(to[b, :n], tr[b, :n])
        np.testing.assert_allclose(lo[b, :n], lr[b, :n], atol=atol, rtol=0)
        if len(mism):
            top2 = np.sort(lr[b, mism[0]])[-2:]
            assert top2[1] - top2[0] <= 2 * atol, \
                f"row {b}: token flip with margin {top2[1] - top2[0]}"


def _engines(arch: str, mode: str):
    jc = dataclasses.replace(C.get_smoke(arch), vocab_size=512)
    tc = dataclasses.replace(TC.get_smoke(arch), vocab_size=512)
    p = jax.jit(T.init_params, static_argnums=0)(jc, jax.random.PRNGKey(0))
    je = JEngine(arch, jc, p, JU(mode=mode))
    model = from_jax_params(jax.tree.map(np.asarray, p), tc)
    te = TEngine(arch, tc, model, TU(mode=mode), device="cpu")
    return je, te


@pytest.fixture(scope="module",
                params=[("smollm-135m", "distribution"),
                        ("smollm-135m", "token"),
                        ("llama3-8b", "distribution")],
                ids=lambda x: f"{x[0]}-{x[1]}")
def engines(request):
    je, te = _engines(*request.param)
    return je, te, je.generate(PROMPTS, MAX_NEW), te.generate(PROMPTS,
                                                               MAX_NEW)


def _logits_np(res):
    return {**res, "logits": np.asarray(res["logits"])}


class TestAgainstJax:
    def test_generate_tokens_tie_aware(self, engines):
        _, _, jres, tres = engines
        assert tres["tokens"].shape == (len(PROMPTS), MAX_NEW)
        assert tres["tokens"].dtype == np.int32
        assert_greedy_match_modulo_ties(_logits_np(tres), _logits_np(jres))

    def test_probe_terms_match(self, engines):
        _, _, jres, tres = engines
        # a row whose stream flipped at a tie describes other tokens: the
        # terms are compared on the rows whose streams are identical
        same = (tres["tokens"] == jres["tokens"]).all(axis=1)
        assert same.sum() >= 3
        for key in ("u", "h_mean", "v_mean"):
            np.testing.assert_allclose(tres[key][same], jres[key][same],
                                       rtol=1e-3, atol=1e-3, err_msg=key)
        np.testing.assert_array_equal(tres["prompt_lengths"],
                                      jres["prompt_lengths"])

    def test_f32_generate_is_tight(self):
        """In f32 with the JAX flash prefill, the two engines compute the
        same math: logits to 1e-4 and the probe terms to 1e-5."""
        jc = dataclasses.replace(C.get_smoke("qwen1.5-110b"), vocab_size=512,
                                 dtype=jnp.float32, attn_prefill_impl="flash")
        tc = dataclasses.replace(TC.get_smoke("qwen1.5-110b"),
                                 vocab_size=512, dtype=torch.float32)
        p = jax.jit(T.init_params, static_argnums=0)(jc,
                                                     jax.random.PRNGKey(2))
        ucfg = dict(alpha=0.3, mode="token")
        jres = JEngine("q", jc, p, JU(**ucfg)).generate(PROMPTS, 6)
        tres = TEngine("q", tc, from_jax_params(jax.tree.map(np.asarray, p),
                                                tc),
                       TU(**ucfg), device="cpu").generate(PROMPTS, 6)
        np.testing.assert_array_equal(tres["tokens"], jres["tokens"])
        np.testing.assert_allclose(tres["logits"].numpy(),
                                   np.asarray(jres["logits"]), atol=1e-4)
        for key in ("u", "h_mean", "v_mean"):
            np.testing.assert_allclose(tres[key], jres[key], atol=1e-5)


class TestPortContracts:
    def test_generate_matches_stepwise(self, engines):
        _, te, _, tres = engines
        step = te.generate_stepwise(PROMPTS, MAX_NEW)
        assert_greedy_match_modulo_ties(_logits_np(step), _logits_np(tres))
        if (step["tokens"] == tres["tokens"]).all():
            np.testing.assert_allclose(step["u"], tres["u"], atol=1e-4)

    def test_serve_matches_generate_with_stop_token(self, engines):
        """Each padded row served on its own through 2 slots equals its row
        of ``generate``, cut after the first stop token."""
        _, te, _, tres = engines
        stop = int(tres["tokens"][0, 3])
        reqs = [Request(rid=i, prompt=PROMPTS[i].tolist(), max_new=MAX_NEW)
                for i in range(len(PROMPTS))]
        fin = te.serve(reqs, n_slots=2, decode_chunk=3, stop_token=stop)
        assert sorted(r["rid"] for r in fin) == list(range(len(PROMPTS)))
        ref = tres["tokens"]
        for r in fin:
            row = ref[r["rid"]]
            hit = np.where(row == stop)[0]
            want = row[:hit[0] + 1] if len(hit) else row
            np.testing.assert_array_equal(r["tokens"], want)
            if len(want) == MAX_NEW:
                np.testing.assert_allclose(r["u"], tres["u"][r["rid"]],
                                           atol=1e-4)
            assert 0.0 <= r["u"] <= 1.0

    def test_serve_without_stop_matches_generate_u(self, engines):
        _, te, _, tres = engines
        reqs = [Request(rid=i, prompt=PROMPTS[i].tolist(), max_new=MAX_NEW)
                for i in range(len(PROMPTS))]
        fin = {r["rid"]: r for r in te.serve(reqs, n_slots=3,
                                             decode_chunk=5)}
        for i in range(len(PROMPTS)):
            np.testing.assert_array_equal(fin[i]["tokens"], tres["tokens"][i])
            np.testing.assert_allclose(fin[i]["u"], tres["u"][i], atol=1e-4)

    def test_unported_paths_raise(self, engines):
        """A mesh that is not a ``DeviceMesh`` raises ``TypeError``
        (engines of every decoder on a mesh, paged and quantized too, are
        ported: test_torch_mesh_engine.py, test_torch_mesh_paged.py,
        test_torch_mesh_mixers.py; warm sessions, paged pools, fault
        injection and the deadline clock: tests/test_torch_continuation.py,
        test_torch_paged.py, test_torch_faults.py; MoE training on a mesh,
        once refused here, gives the one device's loss on the engine's
        (1, 1) shard: test_torch_mesh_training.py trains on meshes).  An
        empty fault plan and a clock no request has a deadline on change
        nothing."""
        _, te, _, tres = engines
        fin = te.serve([Request(rid=0, prompt=PROMPTS[0].tolist(),
                                max_new=MAX_NEW)],
                       faults=FaultPlan([]), step_time_ms=1.0)
        np.testing.assert_array_equal(fin[0]["tokens"], tres["tokens"][0])
        assert not fin[0].get("shed")
        from repro_torch.launch.mesh import serving_mesh
        mesh = serving_mesh(device="cpu")
        paged = TEngine("x", te.cfg, te.params, device="cpu", paged=True,
                        mesh=mesh)
        assert paged.generate(PROMPTS, 2)["tokens"].shape == (len(PROMPTS), 2)
        rg = dataclasses.replace(TC.get_smoke("recurrentgemma-2b"),
                                 vocab_size=512)
        rec = TEngine("x", rg, TT.Transformer(rg), device="cpu", paged=True,
                      block_len=16, mesh=mesh)
        assert rec.generate(PROMPTS, 2)["tokens"].shape == (len(PROMPTS), 2)
        mc = dataclasses.replace(TC.get_smoke("deepseek-moe-16b"),
                                 vocab_size=512)
        w = TT.init_params(mc, torch.Generator().manual_seed(0),
                           device="cpu")
        moe = TEngine("x", mc, w, device="cpu", paged=True, mesh=mesh)
        tokens = torch.as_tensor(PROMPTS)
        batch = {"tokens": tokens, "labels": tokens}
        loss, _ = TT.loss_fn(moe.params, moe._mcfg, batch)
        assert torch.isfinite(loss)
        assert torch.equal(loss, TT.loss_fn(w, mc, batch)[0])
        with pytest.raises(TypeError, match="DeviceMesh"):
            TEngine("x", te.cfg, te.params, device="cpu", mesh=object())


def test_engine_without_device_refuses_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None selects it")
    tc = TC.get_smoke("smollm-135m")
    model = from_jax_params(jax.tree.map(np.asarray, jax.jit(
        T.init_params, static_argnums=0)(C.get_smoke("smollm-135m"),
                                         jax.random.PRNGKey(0))), tc)
    with pytest.raises(RuntimeError, match="CUDA"):
        TEngine("probe", tc, model)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_route_and_budget_match_jax(seed):
    rng = np.random.default_rng(seed)
    B = 32
    u = rng.random(B).astype(np.float32)
    s = rng.random(B).astype(np.float32)
    cost = (rng.random(B) * 0.2).astype(np.float32)
    wan = rng.random(B) > 0.2
    l_edge = (rng.random(B) * 1.0).astype(np.float32)
    l_cloud = (rng.random(B) * 1.0).astype(np.float32)
    want = rng.random(B) > 0.4
    for rcfg in (JR.RouterConfig(tau_low=float(np.quantile(u, 0.4)),
                                 tau_high=float(np.quantile(u, 0.9))),
                 JR.RouterConfig.final()):
        tcfg = TR.RouterConfig(**dataclasses.asdict(rcfg))
        jr = JR.route(jnp.asarray(u), jnp.asarray(s), cfg=rcfg,
                      budget=JB.init_budget(0.7), wan_ok=jnp.asarray(wan),
                      est_cloud_cost=jnp.asarray(cost),
                      l_edge=jnp.asarray(l_edge), l_cloud=jnp.asarray(l_cloud))
        tr = TR.route(torch.from_numpy(u), torch.from_numpy(s), cfg=tcfg,
                      budget=TB.init_budget(0.7), wan_ok=torch.from_numpy(wan),
                      est_cloud_cost=torch.from_numpy(cost),
                      l_edge=torch.from_numpy(l_edge),
                      l_cloud=torch.from_numpy(l_cloud))
        np.testing.assert_array_equal(tr.decision.numpy(),
                                      np.asarray(jr.decision))
        np.testing.assert_array_equal(tr.risk.numpy(), np.asarray(jr.risk))
        assert float(tr.budget.used) == pytest.approx(float(jr.budget.used),
                                                      rel=1e-6)
        assert float(TR.summoning_rate(tr.decision)) == pytest.approx(
            float(JR.summoning_rate(jr.decision)))
    adm_j, st_j = JB.charge_batch(JB.init_budget(0.5), jnp.asarray(cost),
                                  jnp.asarray(want))
    adm_t, st_t = TB.charge_batch(TB.init_budget(0.5), torch.from_numpy(cost),
                                  torch.from_numpy(want))
    np.testing.assert_array_equal(adm_t.numpy(), np.asarray(adm_j))
    assert float(st_t.used) == pytest.approx(float(st_j.used), rel=1e-6)


@pytest.mark.parametrize("mode,invert", [("token", False),
                                         ("distribution", True)])
def test_uncertainty_api_matches_jax(mode, invert):
    """Eq. 2-4 public functions on the same logits: per-position terms,
    masked difficulty and the Eq. 4 combine (f32, summation order only)."""
    rng = np.random.default_rng(4)
    lg = (rng.standard_normal((3, 5, 300)) * 2).astype(np.float32)
    tok = rng.integers(0, 300, (3, 5)).astype(np.int32)
    mask = (rng.random((3, 5)) > 0.3).astype(np.float32)
    lt, tt, mt = (torch.from_numpy(a) for a in (lg, tok, mask))
    lj, tj, mj = (jnp.asarray(a) for a in (lg, tok, mask))
    pairs = [(TUN.token_nent(lt, tt), JUN.token_nent(lj, tj)),
             (TUN.dist_entropy(lt), JUN.dist_entropy(lj)),
             (TUN.topk_logit_variance(lt, 10),
              JUN.topk_logit_variance(lj, 10))]
    kw = dict(alpha=0.4, mode=mode, invert_variance=invert)
    tcfg, jcfg = TU(**kw), JU(**kw)
    pairs += [(TUN.difficulty(lt, tt, tcfg, mt),
               JUN.difficulty(lj, tj, jcfg, mj)),
              (TUN.difficulty(lt, tt, tcfg), JUN.difficulty(lj, tj, jcfg))]
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    assert TUN.combine_terms(0.2, 3.0, tcfg) == pytest.approx(
        float(JUN.combine_terms(0.2, 3.0, jcfg)))


def test_port_imports_neither_jax_nor_repro():
    """Import every module of the port, and chip_smoke, in a fresh process:
    neither ``jax`` nor the JAX package may load."""
    code = (
        "import importlib, pkgutil, sys, runpy\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "runpy.run_path(sys.argv[1], run_name='imported')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code,
                          str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["distribution", "token"])
def test_cuda_generate_matches_cpu(mode):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the chip)")
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.swarm_uncertainty import ops as uops
    from repro_torch.kernels.swarm_uncertainty import ref as uref
    tc = dataclasses.replace(TC.get_smoke("llama3-8b"), vocab_size=512)
    model = TT.init_params(tc, torch.Generator().manual_seed(0))
    cpu = TEngine("c", tc, model, TU(mode=mode), device="cpu")
    ref = cpu.generate(PROMPTS, MAX_NEW)
    gpu = TEngine("g", tc, copy.deepcopy(model), TU(mode=mode))
    for ops in (dops, fops, uops):
        ops.counts.reset()
    out = gpu.generate(PROMPTS, MAX_NEW)
    out["logits"] = out["logits"].cpu()
    assert all(ops.counts.launches > 0 and ops.counts.plain == 0
               for ops in (dops, fops, uops))
    assert_greedy_match_modulo_ties(_logits_np(out), _logits_np(ref))
    # the card's Eq. 2-3 means are the plain version's terms of the card's
    # own logits and tokens (f32 summation order only)
    h, v, hd = uref.uncertainty_ref(out["logits"],
                                    torch.from_numpy(out["tokens"]), k=10)
    np.testing.assert_allclose(
        out["h_mean"], (h if mode == "token" else hd).mean(-1).numpy(),
        rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(out["v_mean"], v.mean(-1).numpy(), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("graphed", [False, True], ids=["eager", "graph"])
@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "mamba2-780m"])
def test_cuda_recurrent_generate_matches_cpu(arch, graphed):
    """The recurrent smoke models in f32 on the card, through the eager
    loop and through a captured dispatch, against the CPU path: tokens
    tie-aware at 1e-4, the kernels of the path launched and no plain
    version run.  (An f32 model's prefill logits are a strided view; the
    eager loop hands them to the uncertainty kernel, which takes
    contiguous rows.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the chip)")
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.swarm_uncertainty import ops as uops
    tc = dataclasses.replace(TC.get_smoke(arch), vocab_size=512,
                             dtype=torch.float32)
    model = TT.init_params(tc, torch.Generator().manual_seed(0))
    with torch.no_grad():           # varied streams (the tied init repeats)
        for name, p in model.named_parameters():
            if p.dim() >= 2 and "embed" not in name and "conv" not in name:
                p.mul_(6)
    ref = TEngine("c", tc, model, TU(mode="distribution"),
                  device="cpu").generate(PROMPTS, MAX_NEW)
    gpu = TEngine("g", tc, copy.deepcopy(model), TU(mode="distribution"))
    if not graphed:
        gpu._graphs = None
    used = (dops, fops, uops) if arch == "recurrentgemma-2b" else (uops,)
    for ops in (dops, fops, uops):
        ops.counts.reset()
    out = gpu.generate(PROMPTS, MAX_NEW)
    out["logits"] = out["logits"].cpu()
    assert all(ops.counts.launches > 0 for ops in used)
    assert all(ops.counts.plain == 0 for ops in (dops, fops, uops))
    assert_greedy_match_modulo_ties(_logits_np(out), _logits_np(ref),
                                    atol=1e-4)
