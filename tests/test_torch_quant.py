"""Row quantization of the paged pools (``repro_torch.models.quant``)
against the JAX package's (``repro.models.quant``), on the same bf16 rows
made from a numpy seed: int8 values and scales exactly, fp8 bytes exactly
(crossing as a uint8 view), a zero row gives scale 0 and dequantizes to 0,
and the mode checks raise as the reference's do."""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # parallel pytest workers share the cores

from repro_torch.models import quant as TQ

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import quant as JQ  # noqa: E402


def _rows(seed: int, shape=(6, 5, 2, 32), scale=3.0):
    """bf16 rows (one all-zero row among them) as a JAX array and the same
    values as a torch tensor."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape).astype(np.float32) * scale
    a[0, 0, 0] = 0.0
    a[1, 2] *= 1e-3                        # small rows: scales far from 1
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j.astype(jnp.float32))).to(
        torch.bfloat16)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("quant", ["int8", "fp8"])
def test_quantize_rows_matches_jax_bytes(quant, seed):
    j, t = _rows(seed)
    jq, js = JQ.quantize_rows(j, quant)
    tq, ts = TQ.quantize_rows(t, quant)
    assert tq.dtype == TQ.qdtype(quant) and ts.dtype == torch.float32
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jb = np.asarray(jq.view(jnp.uint8) if quant == "fp8" else jq)
    tb = (tq.view(torch.uint8) if quant == "fp8" else tq).numpy()
    np.testing.assert_array_equal(tb, jb)
    assert float(ts[0, 0, 0]) == 0.0                  # the zero row
    assert not tq[0, 0, 0].float().any()


@pytest.mark.parametrize("quant", ["int8", "fp8"])
def test_dequantize_rows_matches_jax(quant):
    j, t = _rows(5)
    jq, js = JQ.quantize_rows(j, quant)
    tq, ts = TQ.quantize_rows(t, quant)
    jd = JQ.dequantize_rows(jq, js, jnp.bfloat16)
    td = TQ.dequantize_rows(tq, ts, torch.bfloat16)
    np.testing.assert_array_equal(td.float().numpy(),
                                  np.asarray(jd.astype(jnp.float32)))
    assert not td[0, 0, 0].float().any()
    # the round trip stays within half a quantization step of the row
    err = (td.float() - t.float()).abs().amax(-1)
    step = ts * (1.0 if quant == "int8" else 32.0)
    assert bool((err <= step / 2 + 1e-2 * t.float().abs().amax(-1)).all())


def test_mode_checks():
    assert TQ.CACHE_QUANTS == JQ.CACHE_QUANTS
    assert TQ.QMAX == JQ.QMAX
    assert TQ.qdtype("int8") == torch.int8
    assert TQ.qdtype("fp8") == torch.float8_e4m3fn
    for mod in (TQ, JQ):
        assert mod.check_quant(None) is None
        with pytest.raises(ValueError, match="quantization mode"):
            mod.check_quant("int4")
        with pytest.raises(ValueError, match="quantization mode"):
            mod.qdtype("int4")
