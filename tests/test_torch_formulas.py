"""The parts of the reference's modules a benchmark reads, against the JAX
package: ``core/uncertainty.py``'s ``sequence_entropy``,
``mean_logit_variance`` and ``difficulty_jit`` on random logits with and
without a mask; ``ModelConfig.num_params`` / ``active_params`` for every
arch id; ``configs.SHAPES``, ``applicability`` and ``cells``."""

import dataclasses

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # parallel pytest workers share the cores

from repro_torch import configs as TC
from repro_torch.core import uncertainty as TUN

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as C  # noqa: E402
from repro.core import uncertainty as JUN  # noqa: E402


def _logits(seed, shape=(3, 7, 97)):
    rng = np.random.default_rng(seed)
    lg = (rng.standard_normal(shape) * 3).astype(np.float32)
    tok = rng.integers(0, shape[-1], shape[:-1]).astype(np.int32)
    mask = (rng.random(shape[:-1]) > 0.3).astype(np.float32)
    mask[0] = 0.0                      # a row with no valid position
    return lg, tok, mask


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("mode", ["token", "distribution"])
def test_sequence_entropy_matches_jax(mode, masked):
    lg, tok, mask = _logits(1)
    m = mask if masked else None
    want = JUN.sequence_entropy(jnp.asarray(lg), jnp.asarray(tok),
                                None if m is None else jnp.asarray(m), mode)
    got = TUN.sequence_entropy(torch.from_numpy(lg), torch.from_numpy(tok),
                               None if m is None else torch.from_numpy(m),
                               mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("k", [1, 5, 10])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_mean_logit_variance_matches_jax(masked, k):
    lg, _, mask = _logits(2)
    m = mask if masked else None
    want = JUN.mean_logit_variance(jnp.asarray(lg), k,
                                   None if m is None else jnp.asarray(m))
    got = TUN.mean_logit_variance(torch.from_numpy(lg), k,
                                  None if m is None else torch.from_numpy(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("mode", ["token", "distribution"])
def test_difficulty_jit_matches_jax(mode, masked):
    lg, tok, mask = _logits(3)
    m = mask if masked else None
    kw = dict(alpha=0.3, top_k=5, mode=mode)
    want = JUN.difficulty_jit(jnp.asarray(lg), jnp.asarray(tok),
                              JUN.UncertaintyConfig(**kw),
                              None if m is None else jnp.asarray(m))
    got = TUN.difficulty_jit(torch.from_numpy(lg), torch.from_numpy(tok),
                             TUN.UncertaintyConfig(**kw),
                             None if m is None else torch.from_numpy(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    assert TUN.difficulty_jit is TUN.difficulty


@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_param_counts_match_jax(arch):
    """Counted on a meta-device model, equal to the reference's analytic
    count; the MoE configs' active count leaves out the unrouted
    experts."""
    tc, jc = TC.get_config(arch), C.get_config(arch)
    assert tc.num_params() == jc.num_params()
    assert tc.active_params() == jc.active_params()
    assert (tc.active_params() < tc.num_params()) == (tc.num_experts > 0)


@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_smoke_param_counts_match_jax(arch):
    assert TC.get_smoke(arch).num_params() == C.get_smoke(arch).num_params()


def test_shapes_and_cells_match_jax():
    assert {k: dataclasses.astuple(v) for k, v in TC.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in C.SHAPES.items()}
    assert TC.cells() == C.cells()
    assert TC.cells(include_skipped=True) == C.cells(include_skipped=True)
    for arch in TC.ARCH_IDS:
        for name in TC.SHAPES:
            assert TC.applicability(TC.get_config(arch), TC.SHAPES[name]) \
                == C.applicability(C.get_config(arch), C.SHAPES[name])
    assert set(TC.CELL_ARCHS) | {"swarm-edge-1b"} == set(TC.ARCH_IDS)
