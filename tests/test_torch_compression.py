"""The port's int8 gradient compression (``repro_torch.training.
compression``) against the reference's ``repro/training/compression.py``.

``quantise_int8`` / ``dequantise_int8`` / ``compress_with_feedback`` on
seeded f32 and bf16 arrays equal the reference's bit for bit (the same f32
operations in the same order: a max, a division, round-half-even, a
clip).  ``compressed_psum`` runs on two gloo ranks
(``tests/torch_mesh_ranks.py compress``) and equals the reference formula,
the int32 sum of every participant's payload times the largest scale over
their count, computed here from the reference's ``quantise_int8`` of each
participant's corrected gradient; each rank's new residual equals the
reference's ``compress_with_feedback``'s.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # parallel pytest workers share the cores

from torch_mesh_ranks import compress_inputs

from repro_torch.training import compression as G

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.training import compression as JG  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _arrays(seed: int, shape=(37, 19), scale=3.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32) * scale,
            rng.standard_normal(shape).astype(np.float32) * 1e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantise_and_dequantise_match_reference(seed, dtype):
    x, _ = _arrays(seed, scale=10.0 ** (seed - 1))
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    jq, js = JG.quantise_int8(jx)
    tq, ts = G.quantise_int8(tx)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    for out in ("float32", "bfloat16"):
        jd = JG.dequantise_int8(jq, js, getattr(jnp, out))
        td = G.dequantise_int8(tq, ts, getattr(torch, out))
        np.testing.assert_array_equal(td.float().numpy(),
                                      np.asarray(jd.astype(jnp.float32)))


def test_zero_tensor_keeps_the_scale_floor():
    z = np.zeros((4, 4), np.float32)
    jq, js = JG.quantise_int8(jnp.asarray(z))
    tq, ts = G.quantise_int8(torch.from_numpy(z))
    assert float(ts) == float(js) and not tq.any()


@pytest.mark.parametrize("seed", [0, 3])
def test_compress_with_feedback_matches_reference(seed):
    g, err = _arrays(seed)
    jq, js, je = JG.compress_with_feedback(jnp.asarray(g), jnp.asarray(err))
    tq, ts, te = G.compress_with_feedback(torch.from_numpy(g),
                                          torch.from_numpy(err))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    # the residual carries the quantisation error into the next step
    total = np.asarray(JG.dequantise_int8(jq, js)) + te.numpy()
    np.testing.assert_allclose(total, g + err, rtol=0, atol=1e-6)


def test_init_error_state_zeros_every_leaf():
    m = torch.nn.Linear(3, 2)
    st = G.init_error_state(m)
    assert sorted(st) == ["bias", "weight"]
    assert all(v.dtype == torch.float32 and not v.any() for v in st.values())


def test_compressed_psum_on_two_ranks_matches_the_reference_formula(
        tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, str(ROOT / "tests" /
                                               "torch_mesh_ranks.py"),
                           "compress", str(tmp_path)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-4000:])
    assert "RESULT ok" in proc.stdout, proc.stdout
    with np.load(tmp_path / "out.npz") as z:
        got = {k: z[k] for k in z.files}
    qs, scales = [], []
    for r in range(2):
        g, err = compress_inputs(r)
        q, s, e = JG.compress_with_feedback(jnp.asarray(g), jnp.asarray(err))
        qs.append(np.asarray(q).astype(np.int32))
        scales.append(np.float32(s))
        np.testing.assert_array_equal(got[f"err{r}"], np.asarray(e))
    want = ((qs[0] + qs[1]).astype(np.float32) * max(scales)
            / np.float32(2))
    for r in range(2):
        np.testing.assert_array_equal(got[f"mean{r}"], want)
