"""The sequence-sharded KV cache and the vocabulary-parallel probe, piece by
piece, against the JAX package (smoke sizes, the reference's budgets:
attention 2e-5 f32 / 2e-2 bf16; h 1e-4 f32 / 2e-2 bf16; v 5e-3).

* Rows 1 and 2's plain versions over a cache cut into m runs of slots,
  each run's (o, lse) merged by ``sharding.combine_attention``, equal the
  JAX package's call over the whole cache: runs with no valid slot, a
  wrapped ring, a window, padding queries (which see no key anywhere and
  come out 0).
* Row 3's partials over m cuts of the vocabulary, merged by
  ``ops.merge_partials``, equal ``uncertainty`` on the whole rows and the
  JAX package's Eq. 2-3 terms; ``ops.split_merge(cuts=m)``, the mirror of
  the kernel's walk, too.  ``sharding.merge_attention`` and
  ``vocab_argmax`` on a world of one.
* Placement: under ``SERVE_RULES`` every published (H, K) is placed at
  every model-axis size m = 2..8, and each rank's KV cache
  (``attention.init_kv_cache`` of the rank's config) is the slice the
  reference's ``spec_for`` gives the cache's logical axes on a stub mesh
  (``spec_for`` reads only ``mesh.shape``), for several cache lengths and
  windows, but for case (b)'s one KV head (a documented difference); the
  training rules refuse exactly the shapes only serving places.
* On the card (``-m gpu``, no JAX there): rows 1 and 2 with ``lse`` and
  row 3's partials mode against their plain versions at the ranks' shapes
  of ``chip_smoke.py``'s D4 (o within the attention budget, lse within
  1e-4 f32 / 1e-2 bf16, a row with no valid key -inf and 0, the existing
  mode's output unchanged).
"""

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # parallel pytest workers share the cores

from repro_torch import configs as TC
from repro_torch.distributed import sharding as sh
from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.swarm_uncertainty import ops as uops
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT
from repro_torch.models.common import RankConfig

try:        # the JAX reference; a CUDA machine without JAX runs -m gpu only
    import jax
    import jax.numpy as jnp

    from repro import configs as C
    from repro.core import uncertainty as JU
    from repro.distributed import sharding as jsh
    from repro.kernels.decode_attention import ref as jdref
    from repro.kernels.flash_attention import ref as jfref
    from repro.models import transformer as JT
except ImportError:
    jax = None

needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX package")

ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
H_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
V_TOL = 5e-3


def _j(t: torch.Tensor):
    """A torch tensor as a JAX array of the same dtype (bf16 via f32,
    exact)."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _np(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _runs(T: int, m: int):
    n = T // m
    return [slice(r * n, (r + 1) * n) for r in range(m)]


# ---------------------------------------------------------------------------
# rows 1 and 2 over a cache cut into runs of slots
# ---------------------------------------------------------------------------

DECODE_CASES = [  # (m, window, ring wrapped)
    (2, None, False), (4, None, False), (4, 16, True), (8, None, False)]


@needs_jax
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("m,window,ring", DECODE_CASES,
                         ids=[f"m{m}-w{w}-{'ring' if r else 'linear'}"
                              for m, w, r in DECODE_CASES])
def test_decode_runs_merge_to_the_whole_cache(m, window, ring, dtype):
    """Row 2 over each run, merged, is the JAX package's decode over the
    whole cache.  Row 0 has filled the cache (for a ring: wrapped past it),
    row 1 only the first slots (later runs see no key), row 2 sits in the
    last run."""
    rng = np.random.default_rng(m + (window or 0))
    B, T, K, G, D = 3, 32, 2, 3, 16
    q, k, v = (torch.from_numpy(rng.standard_normal(s, np.float32)).to(dtype)
               for s in ((B, K, G, D), (B, T, K, D), (B, T, K, D)))
    index = np.array([T + 9 if ring else T - 1, 3, T - 2], np.int32)
    pos = np.full((B, T), -1, np.int32)
    for b in range(B):
        for p in range(index[b] + 1):
            slot = p % T
            if ring or p < T:
                pos[b, slot] = p
    if not ring:
        pos[2, :T - 8] = -1                     # row 2: the last run only
    pos_t, idx_t = torch.from_numpy(pos), torch.from_numpy(index)
    parts = [dops.decode_attention(q, k[:, sl].contiguous(),
                                   v[:, sl].contiguous(),
                                   pos_t[:, sl].contiguous(), idx_t,
                                   window=window, lse=True)
             for sl in _runs(T, m)]
    assert any(bool(torch.isinf(l).any()) for _, l in parts), \
        "no run without a valid slot"
    got = sh.combine_attention(torch.stack([o for o, _ in parts]),
                            torch.stack([l for _, l in parts]))
    ref = jdref.decode_attention_ref(_j(q), _j(k), _j(v), jnp.asarray(pos),
                                     jnp.asarray(index), window=window)
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=ATOL[dtype],
                               rtol=0)
    # the whole-cache lse is the log-sum-exp of the runs'
    _, whole = dops.decode_attention(q, k, v, pos_t, idx_t, window=window,
                                     lse=True)
    runs = torch.stack([l for _, l in parts])
    np.testing.assert_allclose(torch.logsumexp(runs, 0).numpy(),
                               whole.numpy(), atol=1e-5, rtol=0)


PREFILL_CASES = [(2, None), (4, None), (4, 12), (8, None)]


@needs_jax
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("m,window", PREFILL_CASES,
                         ids=[f"m{m}-w{w}" for m, w in PREFILL_CASES])
def test_continuation_runs_merge_to_the_whole_cache(m, window, dtype):
    """Row 1 (positions mode) over each run of a warm cache, merged, is the
    JAX package's call over the whole cache: a span at positions 24..29
    then two right-padding queries over a cache holding 0..29 in its first
    30 of 64 slots (the last runs hold nothing).  The
    padding queries see no key anywhere: merged, they come out 0."""
    rng = np.random.default_rng(10 * m + (window or 0))
    B, S, T, H, K, D = 2, 8, 64, 6, 2, 16
    q = torch.from_numpy(rng.standard_normal((B, S, H, D), np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((B, T, K, D), np.float32))
            for _ in range(2))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    qpos = np.array(list(range(24, 30)) + [-2, -1], np.int32)
    kvpos = np.where(np.arange(T) < 30, np.arange(T), -1).astype(np.int32)
    qp, kp = torch.from_numpy(qpos), torch.from_numpy(kvpos)
    parts = [fops.flash_attention_positions(
        q, k[:, sl].contiguous(), v[:, sl].contiguous(), q_positions=qp,
        kv_positions=kp[sl].contiguous(), causal=True, window=window,
        lse=True) for sl in _runs(T, m)]
    assert any(bool(torch.isinf(l).all()) for _, l in parts), \
        "no run without a valid slot"
    got = sh.combine_attention(torch.stack([o for o, _ in parts]),
                            torch.stack([l for _, l in parts]))
    ref = jfref.flash_attention_positions_ref(
        _j(q), _j(k), _j(v), q_positions=jnp.asarray(qpos),
        kv_positions=jnp.asarray(kvpos), causal=True, window=window)
    real = slice(0, 6)
    np.testing.assert_allclose(got[:, real].numpy(), _np(ref)[:, real],
                               atol=ATOL[dtype], rtol=0)
    assert torch.equal(got[:, 6:], torch.zeros_like(got[:, 6:]))


def test_merge_attention_on_a_world_of_one():
    """Over axes of size 1 nothing is gathered: ``merge_attention`` is the
    rank's own output; and ``combine_attention`` of one set is its output
    (finite for a row that sees nothing: 0)."""
    from repro_torch.launch.mesh import serving_mesh
    comm = sh.Comm(serving_mesh(device="cpu"))
    o = torch.randn(2, 3, 4)
    lse = torch.tensor([[0.5, float("-inf"), 1.0], [2.0, 0.0, -1.0]])
    assert sh.merge_attention(o, lse, comm, ("model",), torch.float32) is o
    got = sh.combine_attention(o[None], lse[None])
    assert torch.equal(got[0, 1], torch.zeros(4))
    np.testing.assert_allclose(got[1].numpy(), o[1].numpy(), rtol=1e-6)
    assert comm.stats["all_gather"] == 0


# ---------------------------------------------------------------------------
# row 3 over a vocabulary cut into runs of columns
# ---------------------------------------------------------------------------

@needs_jax
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("m", [2, 4, 8])
def test_probe_partials_merge_to_the_whole_row(m, dtype):
    """Row 3's partials over m cuts of V = 512, merged, are ``uncertainty``
    on the whole rows and the JAX package's Eq. 2-3 terms: chosen tokens at
    0, V - 1 and either side of a cut boundary, a row with ties across a
    boundary, and a peaked row."""
    V, k = 512, 10
    n = V // m
    rng = np.random.default_rng(m)
    lg = rng.standard_normal((6, V)).astype(np.float32) * 3
    lg[4, n - 3:n + 3] = 9.0                    # ties across a boundary
    lg[5, 7] = 40.0                             # peaked
    tok = np.array([0, V - 1, n - 1, n, n + 1, 7], np.int32)
    x = torch.from_numpy(lg).to(dtype)
    t = torch.from_numpy(tok)
    parts = torch.stack([uops.uncertainty_partials(
        x[:, c * n:(c + 1) * n].contiguous(), t, k=k, col0=c * n)
        for c in range(m)])
    assert parts.shape == (m, 6, k + 4)
    h, v, hd = uops.merge_partials(parts, k=k, V=V)
    h0, v0, hd0 = uops.uncertainty(x, t, k=k)
    for a, b, tol in ((h, h0, H_TOL[dtype]), (hd, hd0, H_TOL[dtype]),
                      (v, v0, V_TOL)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=tol, rtol=0)
    jx = _j(x)
    jt = jnp.asarray(tok)
    for a, b, tol in ((h, JU.token_nent(jx, jt), H_TOL[dtype]),
                      (hd, JU.dist_entropy(jx), H_TOL[dtype]),
                      (v, JU.topk_logit_variance(jx, k), V_TOL)):
        np.testing.assert_allclose(a.numpy(), _np(b), atol=tol, rtol=0)
    # the mirror of the kernel's walk, cut the same way
    for a, b in zip(uops.split_merge(x, t, k=k, cuts=m), (h0, v0, hd0)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4, rtol=0)


def test_vocab_argmax_on_a_world_of_one():
    """The first index of the largest logit, ties to the lowest index;
    the split's start offsets it."""
    from repro_torch.launch.mesh import serving_mesh
    comm = sh.Comm(serving_mesh(device="cpu"))
    x = torch.tensor([[0.0, 3.0, 3.0, 1.0], [5.0, -1.0, 5.0, 5.0]])
    got = sh.vocab_argmax(x, sh.Split(comm, ("model",), 8, 4))
    assert got.tolist() == [9, 8]


# ---------------------------------------------------------------------------
# placement and the per-rank cache against the reference's specs
# ---------------------------------------------------------------------------

ATTN_ARCHS = [a for a in TC.ARCH_IDS
              if any(mx in TT.ATTN for mx, _ in TC.get_config(a).layer_plan())]


def _kv_axes(jc) -> tuple:
    """The reference's logical axes of a KV cache's k (its repeat axis, if
    any, dropped)."""
    def walk(x):
        if isinstance(x, dict):
            x = list(x.values())
        if isinstance(x, list):
            return next((y for y in map(walk, x) if y is not None), None)
        return getattr(getattr(x, "kv", None), "k", None)
    ax = walk(JT.cache_axes(jc))
    return tuple(ax[1:]) if len(ax) == 5 else tuple(ax)


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_every_published_head_count_is_placed(arch):
    """Under the serving rules no model-axis size 2..8 raises; under the
    training rules exactly those that cut the query heads but neither
    split the KV heads with them nor give each rank one do."""
    cfg = TC.get_config(arch)
    H, K = cfg.num_heads, cfg.num_kv_heads
    for m in range(2, 9):
        pl = TT.attention_placement(H, K, m)
        assert pl.kind in ("a", "b", "s"), (arch, m, pl)
        refused = H % m == 0 and K % m and m % K
        if refused:
            with pytest.raises(NotImplementedError, match="training"):
                TT.attention_placement(H, K, m, serve=False)
        else:
            assert TT.attention_placement(H, K, m, serve=False).kind in (
                "a", "b", "whole")


@needs_jax
@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_rank_cache_is_the_reference_spec_slice(arch):
    """Each rank's KV cache (the rank config's ``init_kv_cache``, global
    and local layers) has the shape of the slice ``repro.distributed.
    sharding.spec_for`` gives the whole cache under the serving rules, on
    (data, model) stub meshes with m = 2..8, for cache lengths that m
    divides and does not; case (b) holds its one KV head instead."""
    jc, cfg = C.get_config(arch), TC.get_config(arch)
    axes = _kv_axes(jc)
    H, K, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    checked = 0
    for m in range(2, 9):
        pl = TT.attention_placement(H, K, m)
        rank = RankConfig.of(cfg, num_heads=pl.heads, num_kv_heads=pl.kv_heads,
                             kv_seq_shards=pl.kv_seq_shards)
        for data in (1, 2):
            mesh = SimpleNamespace(shape={"data": data, "model": m})
            for B in (4, 3):
                for T in (64, 96, 128, 192, 320, 2048, 4096):
                    for local in (False, True):
                        if local and cfg.window is None:
                            continue
                        Tw = min(T, cfg.window) if local else T
                        spec = jsh.spec_for((B, Tw, K, D), axes, mesh,
                                            jsh.SERVE_RULES.act_rules)
                        sizes = {"data": data, "model": m}
                        want = [n // math.prod(sizes[a] for a in
                                               ((p,) if isinstance(p, str)
                                                else p or ()))
                                for n, p in zip((B, Tw, K, D), list(spec)
                                                + [None] * 4)]
                        if pl.kind == "b":            # its one KV head
                            want[1], want[2] = Tw, 1
                        got = TA.init_kv_cache(rank, want[0], T, local,
                                               device="meta")
                        assert tuple(got.k.shape) == tuple(want), \
                            (arch, m, data, B, T, local, pl, spec)
                        assert tuple(got.pos.shape) == tuple(want[:2])
                        assert isinstance(got, TA.SeqKVCache) == (
                            pl.kind == "s" and want[1] < Tw)
                        checked += 1
    assert checked > 0


# ---------------------------------------------------------------------------
# the new modes on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the chip)")
    return torch.device("cuda")


GPU_TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (2e-2, 1e-2)}
# (B, T, K, G, D, window): D4's ranks -- the probe's T=256 over 2 ranks,
# command-r's 384 over 3, recurrentgemma's 2048-slot ring over 4 -- and a
# cache long enough to split each row over a cluster
DECODE_GPU = [(8, 128, 3, 3, 64, None), (8, 128, 8, 12, 128, None),
              (8, 512, 1, 10, 256, 2048), (2, 1024, 2, 4, 64, None)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,T,K,G,D,window", DECODE_GPU)
def test_decode_lse_kernel_matches_plain(cuda, B, T, K, G, D, window, dtype):
    """Row 2 with ``lse`` on the card against its plain version: rows
    whose slots run past the index, a row that sees no slot (lse -inf, o
    0); the existing mode's output is the lse mode's on every other row."""
    g = torch.Generator(device=cuda).manual_seed(T + D)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(dtype)
               for s in ((B, K, G, D), (B, T, K, D), (B, T, K, D)))
    idx = torch.randint(T // 4, T, (B,), generator=g, device=cuda,
                        dtype=torch.int32)
    ar = torch.arange(T, device=cuda, dtype=torch.int32)
    pos = torch.where(ar[None] <= idx[:, None], ar[None], -1).to(
        torch.int32).contiguous()
    pos[0] = -1                                  # sees no slot
    o, lse = dops.decode_attention(q, k, v, pos, idx, window=window, lse=True)
    ro, rl = dops.R.decode_attention_ref(q, k, v, pos, idx, window=window,
                                         lse=True)
    torch.cuda.synchronize()
    ot, lt = GPU_TOL[dtype]
    assert float((o.float() - ro.float()).abs().max()) <= ot
    seen = torch.isfinite(rl)
    assert torch.equal(seen, torch.isfinite(lse))
    assert not bool(seen[0].any()) and bool(seen[1:].all())
    assert float((lse[seen] - rl[seen]).abs().max()) <= lt
    assert bool((o[0] == 0).all())
    base = dops.decode_attention(q, k, v, pos, idx, window=window)
    assert o.dtype == torch.float32
    assert torch.equal(base[1:], o[1:].to(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,T,H,K,D", [(8, 16, 128, 9, 3, 64),
                                         (4, 16, 128, 96, 8, 128),
                                         (2, 64, 512, 10, 1, 256)])
def test_continuation_lse_kernel_matches_plain(cuda, B, S, T, H, K, D,
                                               dtype):
    """Row 1 (positions mode) with ``lse`` over a warm cache's run of
    slots: the span's queries see the slots below them, two padding
    queries see none (lse -inf, o 0); the existing mode's output is the
    lse mode's on the real queries."""
    g = torch.Generator(device=cuda).manual_seed(S + H)
    q = torch.randn((B, S, H, D), generator=g, device=cuda).to(dtype)
    k, v = (torch.randn((B, T, K, D), generator=g, device=cuda).to(dtype)
            for _ in range(2))
    p0 = T // 2
    qpos = torch.cat([torch.arange(p0, p0 + S - 2, device=cuda),
                      torch.tensor([-2, -1], device=cuda)]).to(torch.int32)
    ar = torch.arange(T, device=cuda)
    kvpos = torch.where(ar < p0 + S - 2, ar, -1).to(torch.int32)
    kw = dict(q_positions=qpos, kv_positions=kvpos, causal=True)
    o, lse = fops.flash_attention_positions(q, k, v, lse=True, **kw)
    ro, rl = fops.R.flash_attention_positions_ref(q, k, v, lse=True, **kw)
    torch.cuda.synchronize()
    ot, lt = GPU_TOL[dtype]
    assert float((o.float() - ro.float()).abs().max()) <= ot
    assert bool(torch.isinf(lse[:, -2:]).all()) and bool(
        (o[:, -2:] == 0).all())
    assert float((lse[:, :-2] - rl[:, :-2]).abs().max()) <= lt
    base = fops.flash_attention_positions(q, k, v, **kw)
    assert o.dtype == torch.float32
    assert torch.equal(base[:, :-2], o[:, :-2].to(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("V,m", [(49152, 2), (256000, 4), (256000, 3)])
def test_partials_kernel_matches_plain(cuda, V, m, dtype):
    """Row 3's partials mode on each of m vocabulary cuts against its plain
    version (m, the chosen logit and the top-k exact; l and s relative
    1e-4), and merged over the cuts against the whole rows' plain
    ``uncertainty`` within the probe's budget.  m = 3 leaves a remainder
    that no cut takes: the cuts cover V - V % 3 columns, as a whole row of
    that width."""
    n = V // m
    W = n * m
    g = torch.Generator(device=cuda).manual_seed(V + m)
    lg = (torch.randn((8, W), generator=g, device=cuda) * 3).to(dtype)
    tok = torch.randint(0, W, (8,), generator=g, device=cuda,
                        dtype=torch.int32)
    top = torch.topk(lg.float(), 3, -1).indices
    tok[:3] = top[:3, 0].to(torch.int32)           # likely tokens
    tok[3] = n - 1                                  # either side of a cut
    tok[4] = n
    parts = []
    for c in range(m):
        x = lg[:, c * n:(c + 1) * n].contiguous()
        got = uops.uncertainty_partials(x, tok, k=10, col0=c * n)
        want = uops.R.uncertainty_partials_ref(x, tok, k=10, col0=c * n)
        torch.cuda.synchronize()
        for i in (0, 3):
            assert torch.equal(got[:, i], want[:, i]), (c, i)
        assert torch.equal(got[:, 4:], want[:, 4:]), c
        # l relative; s against l times the cut's largest |logit| (a sum
        # of signed terms may be near 0)
        scale = want[:, 1] * x.float().abs().amax(-1)
        assert float(((got[:, 1] - want[:, 1]).abs() / want[:, 1]).max()) \
            <= 1e-4, c
        assert float(((got[:, 2] - want[:, 2]).abs() / scale).max()) \
            <= 1e-4, c
        parts.append(got)
    h, v, hd = uops.merge_partials(torch.stack(parts), k=10, V=W)
    h0, v0, hd0 = uops.R.uncertainty_ref(lg, tok, k=10)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert float((h - h0).abs().max()) <= tol
    assert float((hd - hd0).abs().max()) <= tol
    assert float((v - v0).abs().max()) <= 5e-3
