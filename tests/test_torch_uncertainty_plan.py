"""The launch plan of the uncertainty kernel (``kernels.swarm_uncertainty.
ops.uncertainty_plan``) and the mirror of its split-then-merge arithmetic
(``ops.split_merge``), on the CPU: no CUDA kernel runs here.

* The splits of a row cover its logits [0, V) exactly once, every block's
  vector body starts on a 16-byte boundary and holds whole vectors, and
  every thread reads what ``UncertaintyPlan.owned`` says, for rows 1-400,
  the gateway's and odd vocabularies and k in {1, 10, 16}.
* ``rows * splits`` fills the card's 132 SMs at the main path's shapes, and
  every row with V >= 32000 there is split.
* The mirror (per-thread partial states over the plan's walk, merged per
  warp, block and cluster) equals the plain version (``ref.uncertainty_
  ref``) and JAX's ``uncertainty_ref`` on seeded numpy logits, within the
  reference's budgets: h 1e-4 in f32 and 2e-2 in bf16, the top-k variance
  5e-3, h_dist 1e-4.  The cases hold tied maxima that straddle a chunk
  boundary, chosen tokens at 0, at V-1 and on either side of a boundary, a
  chunk shorter than k and the +-1e4 extremes of
  ``test_extreme_logits_stable``.

The ``gpu`` cases hold the kernel on the card to the plain version on the
same set, with the plan of each case.
"""

import zlib

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # parallel pytest workers share the cores

from repro_torch.kernels.swarm_uncertainty import ops as uops
from repro_torch.kernels.swarm_uncertainty import ref as uref

try:        # the JAX reference; a CUDA machine without JAX runs -m gpu only
    import jax
    import jax.numpy as jnp

    from repro.kernels.swarm_uncertainty.ref import \
        uncertainty_ref as _unc_ref
except ImportError:
    jax = None
else:
    jax_ref = jax.jit(_unc_ref, static_argnames="k")

BF16 = torch.bfloat16
VOCABS = [128, 1000, 32000, 49152, 50257, 128256, 152064]
DTYPES = {"float32": torch.float32, "bfloat16": BF16}


@pytest.mark.parametrize("V", VOCABS)
@pytest.mark.parametrize("k", [1, 10, 16])
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=str)
def test_plan_covers_every_logit_once(V, k, dtype):
    """For every row count 1-400: splits in [1, 8], chunks a multiple of 8
    that leave no block empty and cover [0, V) once; each block's head and
    tail are shorter than a vector and its body starts 16-byte aligned.
    The threads' walk (``owned``) reads every logit once, for rows of
    every 16-byte phase."""
    vec = 4 if dtype == torch.float32 else 8
    for rows in range(1, 401):
        plan = uops.uncertainty_plan(rows, V, k, dtype)
        assert plan.vec == vec and 1 <= plan.splits <= uops.MAX_SPLITS
        assert plan.chunk % uops.CHUNK_ALIGN == 0
        assert plan.grid == rows * plan.splits
        assert plan.splits == 1 or V // plan.splits >= uops.MIN_CHUNK
        last = 0
        for r in (0, rows - 1):
            for s in range(plan.splits):
                c0, b0, b1, c1 = plan.parts(r, s)
                assert c0 == last and c0 < c1 and c0 <= b0 <= b1 <= c1
                assert (r * V + b0) % vec == 0 or b0 == c1
                assert (b1 - b0) % vec == 0 and b0 - c0 < vec
                assert c1 - b1 < vec
                last = c1
            assert last == V
            last = 0
    plan = uops.uncertainty_plan(8, V, k, dtype)
    phases = {}
    for r in range(vec):
        phases.setdefault(r * V % vec, r)
    for r in phases.values():             # every phase of a row start
        seen = torch.zeros(V, dtype=torch.int64)
        for s in range(plan.splits):
            idx = plan.owned(r, s)
            c0, c1 = plan.bounds(s)
            got = idx[idx >= 0]
            assert ((got >= c0) & (got < c1)).all()
            seen += torch.bincount(got, minlength=V)
        assert (seen == 1).all()


@pytest.mark.parametrize("rows", [8, 50])
@pytest.mark.parametrize("V", [32000, 49152, 128256, 152064])
def test_plan_fills_the_card_at_the_main_path(rows, V):
    """The probe's generate (B=8) and the gateway (B=50) at the tiers'
    vocabularies: every row is split, and the blocks fill the 132 SMs as
    far as the cluster size lets them."""
    for dtype in (torch.float32, BF16):
        plan = uops.uncertainty_plan(rows, V, 10, dtype)
        assert plan.splits > 1
        assert plan.grid >= min(uops.SMS, rows * uops.MAX_SPLITS)
        assert plan.grid <= uops.TARGET_BLOCKS + rows


def test_plan_refuses_what_the_kernel_cannot_take():
    for bad in (dict(k=0), dict(k=17), dict(V=8, k=10)):
        kw = dict(rows=2, V=1000, k=10, dtype=torch.float32) | bad
        with pytest.raises(ValueError):
            uops.uncertainty_plan(**kw)
    with pytest.raises(TypeError):
        uops.uncertainty_plan(2, 1000, 10, torch.float16)
    lt = torch.zeros(2, 1000)
    tok = torch.zeros(2, dtype=torch.int32)
    for plan in (uops.UncertaintyPlan(2, 1000, 2, 496, 4),   # leaves 8
                 uops.UncertaintyPlan(2, 1000, 2, 500, 4),   # not aligned
                 uops.UncertaintyPlan(2, 1000, 3, 504, 4),   # empty last
                 uops.UncertaintyPlan(2, 1000, 1, 1000, 8)):  # bf16's vec
        with pytest.raises(ValueError):
            uops.split_merge(lt, tok, k=10, plan=plan)


# ---------------------------------------------------------------------------
# the mirror's cases (numpy, seeded): (logits (R, V) f32, tokens (R,), k,
# plan or None = uncertainty_plan's)
# ---------------------------------------------------------------------------

def _boundaries(V, rows, dtype):
    plan = uops.uncertainty_plan(rows, V, 10, dtype)
    return [plan.bounds(s)[0] for s in range(1, plan.splits)]


def _case(name: str, dtype):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if name.startswith("normal"):
        V, k = (int(x) for x in name.split("-")[1:])
        R = 3
        lg = rng.standard_normal((R, V)).astype(np.float32) * 3
        tok = rng.integers(0, V, R).astype(np.int32)
        tok[0] = int(np.argmax(lg[0]))              # a likely token
        return lg, tok, k, None
    if name == "ties-straddle":
        # tied maxima across the boundaries of rank 0/1 (4 copies) and of
        # ranks 3/4 (12 copies: more than k), the chosen token on either
        # side of the boundary
        V, R = 49152, 8
        lg = rng.standard_normal((R, V)).astype(np.float32) * 3
        b = _boundaries(V, R, dtype)
        top = float(lg.max()) + 1.0
        lg[0, b[0] - 2:b[0] + 2] = top
        lg[1, b[3] - 6:b[3] + 6] = top
        tok = rng.integers(0, V, R).astype(np.int32)
        tok[0], tok[1] = b[0] - 1, b[3]
        return lg, tok, 10, None
    if name == "chosen-edges":
        # the chosen token at 0, V-1 and either side of a boundary, each
        # the row's largest logit so Eq. 2's term is not ~0
        V, R = 50257, 4
        lg = rng.standard_normal((R, V)).astype(np.float32) * 3
        b = _boundaries(V, 8, dtype)[3]
        tok = np.array([0, V - 1, b - 1, b], np.int32)
        lg[np.arange(R), tok] = lg.max() + 0.5
        return lg, tok, 10, ("rows", 8)
    if name.startswith("short-chunk"):
        # the second block holds 8 logits, fewer than k: its list is
        # padded, and its values still count
        k = int(name.split("-")[-1])
        V, R = 1000, 3
        lg = rng.standard_normal((R, V)).astype(np.float32) * 3
        lg[:, -3:] = lg.max() + np.array([1.0, 2.0, 2.0])
        tok = np.array([999, 992, 5], np.int32)
        return lg, tok, k, ("plan", 2, 992)
    if name.startswith("extreme"):
        # test_extreme_logits_stable's rows: -1e4 with one +1e4, chosen;
        # at V=49152 the +1e4 sits on a block boundary
        V, k = (512, 4) if name == "extreme-512" else (49152, 10)
        R = 8 if V == 512 else 2
        lg = np.full((R, V), -1e4, np.float32)
        at = 0 if V == 512 else _boundaries(V, R, dtype)[2]
        lg[:, at] = 1e4
        return lg, np.full((R,), at, np.int32), k, None
    raise KeyError(name)


CASES = [f"normal-{V}-{k}" for V in (128, 1000, 32000, 50257)
         for k in (1, 10, 16)] + [
    "ties-straddle", "chosen-edges", "short-chunk-10", "short-chunk-16",
    "extreme-512", "extreme-49152"]


def _inputs(name, dtype_name):
    dtype = DTYPES[dtype_name]
    lg, tok, k, how = _case(name, dtype)
    lt = torch.from_numpy(lg).to(dtype)
    tt = torch.from_numpy(tok)
    R, V = lg.shape
    if how is None:
        plan = uops.uncertainty_plan(R, V, k, dtype)
    elif how[0] == "rows":          # the split of a larger batch's plan
        p = uops.uncertainty_plan(how[1], V, k, dtype)
        plan = uops.UncertaintyPlan(R, V, p.splits, p.chunk, p.vec)
    else:
        plan = uops.UncertaintyPlan(R, V, how[1], how[2],
                                    16 // lt.element_size())
    return lt, tt, k, plan


def _budgets(dtype_name):
    h = 1e-4 if dtype_name == "float32" else 2e-2
    return h, 5e-3, 1e-4


def _assert_close(out, ref, dtype_name):
    for o, r, t in zip(out, ref, _budgets(dtype_name)):
        np.testing.assert_allclose(np.asarray(o, np.float32),
                                   np.asarray(r, np.float32), rtol=t, atol=t)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("name", CASES)
def test_mirror_matches_plain_and_jax(name, dtype_name):
    lt, tt, k, plan = _inputs(name, dtype_name)
    assert plan.splits > 1 or lt.shape[-1] < 2 * uops.MIN_CHUNK
    out = uops.split_merge(lt, tt, k=k, plan=plan)
    for o in out:
        assert torch.isfinite(o).all()
    _assert_close(out, uref.uncertainty_ref(lt, tt, k=k), dtype_name)
    if jax is not None:
        lj = jnp.asarray(lt.float().numpy()).astype(getattr(jnp, dtype_name))
        _assert_close(out, jax_ref(lj, jnp.asarray(tt.numpy()), k=k),
                      dtype_name)


def test_mirror_short_chunk_counts_its_values():
    """The 8-logit block holds the row's three largest logits (two tied):
    they lead the top-k, and the chosen token there carries most of the
    mass."""
    lt, tt, k, plan = _inputs("short-chunk-10", "float32")
    h, v, hd = uops.split_merge(lt, tt, k=k, plan=plan)
    top = torch.topk(lt, k, -1).values
    assert plan.bounds(1) == (992, 1000)
    torch.testing.assert_close(v, top.var(-1, unbiased=False), rtol=1e-5,
                               atol=1e-5)
    assert float(h[0]) > 0.1                  # chosen: a tied maximum


def test_mirror_unaligned_row_starts():
    """A tensor whose first logit sits off a 16-byte boundary (a view of
    an odd row onward): the walk realigns every block and still reads each
    logit once."""
    plan = uops.uncertainty_plan(4, 50257, 10, torch.float32)
    for base in range(1, 4):
        for r in range(4):
            seen = torch.zeros(50257, dtype=torch.int64)
            for s in range(plan.splits):
                c0, b0, b1, c1 = plan.parts(r, s, base)
                assert (base + r * 50257 + b0) % 4 == 0 or b0 == c1
                got = plan.owned(r, s, base)
                seen += torch.bincount(got[got >= 0], minlength=50257)
            assert (seen == 1).all()


# ---------------------------------------------------------------------------
# the kernel on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the chip)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("name", CASES)
def test_kernel_matches_plain(cuda, name, dtype_name):
    lt, tt, k, plan = _inputs(name, dtype_name)
    uops.counts.reset()
    out = uops._launch(lt.to(cuda), tt.to(cuda), k, plan)
    torch.cuda.synchronize()
    assert (uops.counts.launches, uops.counts.plain) == (1, 0)
    out = [o.cpu() for o in out]
    for o in out:
        assert torch.isfinite(o).all()
    _assert_close(out, uref.uncertainty_ref(lt, tt, k=k), dtype_name)
    _assert_close(out, uops.split_merge(lt, tt, k=k, plan=plan), dtype_name)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_kernel_unaligned_rows_and_default_plan(cuda, dtype_name):
    """Rows of an odd vocabulary from a view one row in (no row starts on
    a 16-byte boundary), with the wrapper's own plan, at the gateway's
    B=50: every row is split."""
    rng = np.random.default_rng(7)
    V = 50257
    full = torch.from_numpy(rng.standard_normal((51, V)).astype(
        np.float32) * 3).to(DTYPES[dtype_name])
    lt = full.to(cuda)[1:]
    tok = torch.from_numpy(rng.integers(0, V, 50).astype(np.int32))
    out = uops.uncertainty(lt, tok.to(cuda), k=10)
    torch.cuda.synchronize()
    assert uops.uncertainty_plan(50, V, 10, lt.dtype).splits > 1
    _assert_close([o.cpu() for o in out],
                  uref.uncertainty_ref(full[1:], tok, k=10), dtype_name)
