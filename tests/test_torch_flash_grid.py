"""The port's grid-offset flash attention (``flash_attention``, the
safety encoder's and ``transformer.forward``'s attention) against the JAX
package's ``flash_attention_ref`` and ``flash_attention_pallas`` (interpret
mode), the kernel table of ``kernels/build.py``, and the launch plan both
flash entry points take on the card (``ops.launch_plan``: body, row
mapping, tiles, grid), whose block -> rows decode must cover every output
row exactly once.

On the CPU the wrapper runs its plain version; the ``gpu`` tests hold the
CUDA kernel to it on the card and skip where there is none.  The sweep
covers causal, windowed and bidirectional masks, G = 1, 2, 3, S != T, S not
a multiple of the kernel's 64-row tile, and head widths 32 and 64 (the
safety encoder's D = 32 among them); on the card also the packed mapping
(S=8, G=8), S and T ragged against the bf16 body's 128-slot K/V tiles with
S < T and S > T, windows across tile edges, and D = 16 and 256.  A query
row that sees no key (a window with S - T >= window) is refused by the
wrapper: there the reference
gives the mean of V over all T, while the kernels (Pallas and CUDA) skip
the tiles no row of the tile can see.

Budgets are the reference's own (tests/test_kernels.py): 2e-5 in f32
(summation order only), 2e-2 in bf16 (the output is rounded to bf16).
"""

import re

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # parallel pytest workers share the cores

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention import ref as fref

try:        # the JAX reference; a CUDA machine without JAX runs -m gpu only
    import jax
    import jax.numpy as jnp

    from repro.kernels.flash_attention.kernel import flash_attention_pallas
    from repro.kernels.flash_attention.ref import \
        flash_attention_ref as _flash_ref
except ImportError:
    jax = None
else:
    flash_attention_ref = jax.jit(_flash_ref,
                                  static_argnames=("causal", "window"))

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}

# (B, S, T, H, K, D, causal, window)
SWEEP = [
    (4, 6, 6, 4, 4, 32, False, None),       # the safety encoder's shape
    (2, 100, 100, 4, 4, 32, False, None),   # bidirectional, G=1, ragged S
    (2, 96, 160, 6, 3, 64, True, None),     # causal, G=2, S < T
    (1, 100, 64, 4, 2, 64, True, None),     # causal, S > T
    (1, 130, 130, 9, 3, 64, True, 48),      # causal + window, G=3
    (1, 40, 70, 4, 2, 32, False, 16),       # window without causal, S < T
    (1, 256, 256, 8, 2, 64, True, None),    # several tiles each way
]


def _ids(case):
    B, S, T, H, K, D, causal, window = case
    mode = ("causal" if causal else "bidir") + (f"-w{window}" if window
                                                else "")
    return f"B{B}-S{S}-T{T}-H{H}-K{K}-D{D}-{mode}"


def _inputs(B, S, T, H, K, D, dtype, seed):
    """q, k, v as numpy f32 rounded to ``dtype`` once, so both packages see
    the same values."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in ((B, S, H, D), (B, T, K, D), (B, T, K, D)):
        t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        out.append(t.to(DTYPES[dtype]))
    return out


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _jax(t: torch.Tensor, dtype: str):
    return jnp.asarray(t.float().numpy()).astype(getattr(jnp, dtype))


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the chip)")
    return torch.device("cuda")


@pytest.mark.parametrize("case", SWEEP, ids=_ids)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_matches_jax(case, dtype):
    if jax is None:
        pytest.skip("needs the JAX reference")
    B, S, T, H, K, D, causal, window = case
    q, k, v = _inputs(B, S, T, H, K, D, dtype, seed=S * 7 + T)
    kw = dict(causal=causal, window=window)
    fops.grid_counts.reset()
    out = fops.flash_attention(q, k, v, **kw)
    assert fops.grid_counts.plain == 1 and fops.grid_counts.launches == 0
    assert out.dtype == q.dtype and out.shape == q.shape
    qj, kj, vj = (_jax(t, dtype) for t in (q, k, v))
    np.testing.assert_allclose(_np(out), _np(flash_attention_ref(
        qj, kj, vj, **kw)), rtol=TOL[dtype], atol=TOL[dtype])
    if dtype == "float32" or case == SWEEP[0]:
        # interpret mode is slow in bf16: every f32 case, one bf16 case
        pal = flash_attention_pallas(qj, kj, vj, bq=64, bk=32,
                                     interpret=True, **kw)
        np.testing.assert_allclose(_np(out), _np(pal), rtol=TOL[dtype],
                                   atol=TOL[dtype])


def test_gqa_head_mapping():
    """Head h reads KV head h // G for G that is not a power of two."""
    q, k, v = _inputs(1, 20, 20, 9, 3, 16, "float32", seed=3)
    out = fops.flash_attention(q, k, v, causal=True)
    for h in range(9):
        one = fops.flash_attention(
            q[:, :, h:h + 1].contiguous(),
            k[:, :, h // 3:h // 3 + 1].contiguous(),
            v[:, :, h // 3:h // 3 + 1].contiguous(), causal=True)
        torch.testing.assert_close(out[:, :, h:h + 1], one)


def test_wrapper_rejects_bad_operands():
    q, k, v = _inputs(1, 8, 8, 4, 2, 16, "float32", seed=1)
    with pytest.raises(ValueError):
        fops.flash_attention(q, k, v, window=0)
    with pytest.raises(ValueError):
        fops.flash_attention(q, k[:, :, :1].repeat(1, 1, 3, 1),
                             v[:, :, :1].repeat(1, 1, 3, 1))   # H % K != 0
    with pytest.raises(TypeError):
        fops.flash_attention(q, k.to(torch.bfloat16), v)
    # S - T >= window: the last query rows would see no key
    for causal in (True, False):
        with pytest.raises(ValueError, match="no key"):
            fops.flash_attention(q, k[:, :4], v[:, :4], causal=causal,
                                 window=4)
        out = fops.flash_attention(q, k[:, :4], v[:, :4], causal=causal,
                                   window=5)
        assert torch.isfinite(out).all()


def test_signatures_name_entry_points():
    """``SIGNATURES`` maps C entry points to their library: every entry is
    defined in its ``csrc/<library>.cu`` with as many parameters as its
    ctypes argtypes, and every library is built."""
    assert set(build.LIBRARIES) == {"flash_attention", "decode_attention",
                                    "swarm_uncertainty"}
    for entry, (lib, argtypes) in build.SIGNATURES.items():
        src = (build.CSRC / f"{lib}.cu").read_text()
        m = re.search(rf'extern "C" int {entry}\(([^)]*)\)', src)
        assert m, f"{entry} is not an entry point of {lib}.cu"
        assert len(m.group(1).split(",")) == len(argtypes), entry
    assert build.SIGNATURES["flash_attention"][0] == \
        build.SIGNATURES["flash_attention_positions"][0]


# (B, S, T, H, K, D): G = 1, 3, 4, 8 at the gateway's S = 6..8, S * G just
# above one warpgroup's 64 rows and a block's 128, and S = T = 2048
PLAN_SHAPES = [
    (3, 6, 6, 4, 4, 32), (3, 7, 7, 9, 3, 64), (3, 8, 8, 16, 4, 64),
    (3, 8, 8, 64, 8, 128), (2, 17, 17, 8, 2, 64), (2, 22, 22, 9, 3, 64),
    (2, 33, 33, 8, 2, 64), (2, 43, 43, 9, 3, 64), (2, 12, 320, 9, 3, 64),
    (2, 2048, 2048, 9, 3, 64), (1, 2048, 2048, 32, 8, 128),
]
PLAN_MODES = {"positions": dict(grid_mode=False, causal=True),
              "grid-causal": dict(grid_mode=True, causal=True),
              "grid-bidir": dict(grid_mode=True, causal=False)}


@pytest.mark.parametrize("shape", PLAN_SHAPES,
                         ids=lambda s: "B{}-S{}-T{}-H{}-K{}-D{}".format(*s))
@pytest.mark.parametrize("mode", sorted(PLAN_MODES))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_launch_plan_covers_every_row_once(shape, mode, dtype):
    """Every (b, s, h) output row is stored by exactly one block, and every
    row of a block reads one KV head."""
    B, S, T, H, K, D = shape
    plan = fops.launch_plan(B, S, T, H, K, D, DTYPES[dtype],
                            **PLAN_MODES[mode])
    assert plan.body == ("wgmma" if dtype == "bfloat16" else "simt")
    seen = torch.zeros((B, S, H), dtype=torch.int32)
    for block in range(int(np.prod(plan.grid))):
        b, s, h = plan.block_rows(block)
        assert 0 < len(s) <= plan.tile_rows
        assert len(set((h // (H // K)).tolist())) == 1
        seen.index_put_((b, s, h), torch.ones_like(s, dtype=torch.int32),
                        accumulate=True)
    assert bool((seen == 1).all())
    if plan.body == "wgmma":
        assert plan.packed == (H > K and S * (H // K) <= 128)
        assert plan.tile_rows == (64 if S * plan.gp <= 64 else 128)
        assert plan.stages == min(-(-T // plan.bk), 2)


@pytest.mark.parametrize("tier", ["probe", "edge_1b", "edge_qwen", "cloud"])
def test_launch_plan_packs_gateway_shapes(tier):
    """The gateway's prefill (50 prompts bucketed to S=8) takes the packed
    mapping at every tier's widths: one block per (prompt, KV head), K/V
    loaded once, not G times."""
    from repro_torch.launch.serve import tier_configs
    tc = tier_configs()[tier]
    H, K, D = tc.num_heads, tc.num_kv_heads, tc.head_dim
    plan = fops.launch_plan(50, 8, 8, H, K, D, torch.bfloat16,
                            grid_mode=False)
    assert plan.packed and plan.gp == H // K and plan.grid == (50 * K,)
    assert plan.tile_rows == 64 and plan.stages == 1     # one K/V tile


@pytest.mark.parametrize("D", [8, 24, 40, 264])
def test_launch_plan_refuses_bf16_head_dims(D):
    """The tensor-core body steps D by wgmma's 16; f32 takes any D."""
    with pytest.raises(ValueError, match="multiples of 16"):
        fops.launch_plan(1, 8, 8, 4, 2, D, torch.bfloat16, grid_mode=True)
    if D <= 256:
        assert fops.launch_plan(1, 8, 8, 4, 2, D, torch.float32,
                                grid_mode=True).body == "simt"


@pytest.mark.gpu
@pytest.mark.parametrize("case", SWEEP + [
    (50, 6, 6, 4, 4, 32, False, None),     # the safety gate at B=50
    (2, 300, 300, 32, 8, 128, True, None),
    (4, 8, 8, 64, 8, 128, True, None),     # packed, G=8
    (1, 130, 300, 4, 2, 64, True, None),   # ragged against BK, S < T
    (1, 300, 130, 4, 2, 64, True, None),   # ragged, S > T
    (1, 300, 300, 8, 2, 64, True, 100),    # a window across tile edges
    (1, 260, 260, 8, 2, 64, False, 150),   # window without causal
    (2, 70, 70, 4, 2, 16, True, None),     # D = 16
    (1, 200, 200, 4, 2, 256, True, None),  # D = 256 (K/V tiles of 64)
], ids=_ids)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kernel_matches_plain(cuda, case, dtype):
    B, S, T, H, K, D, causal, window = case
    q, k, v = _inputs(B, S, T, H, K, D, dtype, seed=S + T)
    kw = dict(causal=causal, window=window)
    fops.grid_counts.reset()
    out = fops.flash_attention(q.to(cuda), k.to(cuda), v.to(cuda), **kw)
    torch.cuda.synchronize()
    assert fops.grid_counts.launches == 1 and fops.grid_counts.plain == 0
    ref = fref.flash_attention_ref(q, k, v, **kw)
    np.testing.assert_allclose(_np(out.cpu()), _np(ref), rtol=TOL[dtype],
                               atol=TOL[dtype])
