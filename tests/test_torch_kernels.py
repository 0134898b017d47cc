"""The port's kernel wrappers (``repro_torch.kernels``) against the JAX
package's oracles and Pallas kernels (interpret mode), on the monolithic
shape sweeps of tests/test_kernels.py.

On the CPU each wrapper runs its plain PyTorch version, which is what these
tests hold to ``*_ref`` and ``*_pallas(interpret=True)``; the tests marked
``gpu`` hold each CUDA kernel to its plain version on the card and skip
where there is none.  All inputs come from numpy seeds and are handed to
both packages; bf16 inputs are rounded once (through JAX) and given to both
as the same bf16 values.

Tolerances are the reference's own kernel budgets (tests/test_kernels.py):
attention 2e-5 in f32 (summation order only) and 2e-2 in bf16 (the output
is rounded to bf16); uncertainty h 1e-4 in f32 and 2e-2 in bf16; the top-k
variance 5e-3 (a difference of squares of logits of size ~10).
"""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # parallel pytest workers share the cores

from repro_torch.kernels import blocking
from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.kernels.decode_attention import ref as dref
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention import ref as fref
from repro_torch.kernels.swarm_uncertainty import ops as uops
from repro_torch.kernels.swarm_uncertainty import ref as uref

try:        # the JAX reference; a CUDA machine without JAX runs -m gpu only
    import jax
    import jax.numpy as jnp

    from repro.kernels import blocking as jblocking
    from repro.kernels.decode_attention.kernel import decode_attention_pallas
    from repro.kernels.decode_attention.ref import \
        decode_attention_ref as _decode_ref
    from repro.kernels.flash_attention.kernel import \
        flash_attention_positions_pallas
    from repro.kernels.flash_attention.ref import \
        flash_attention_positions_ref as _flash_ref
    from repro.kernels.swarm_uncertainty.kernel import uncertainty_pallas
    from repro.kernels.swarm_uncertainty.ref import \
        uncertainty_ref as _unc_ref
except ImportError:
    jax = None
else:
    # the JAX oracles, jitted: one compile instead of an op-by-op dispatch
    decode_attention_ref = jax.jit(_decode_ref, static_argnames="window")
    flash_attention_positions_ref = jax.jit(
        _flash_ref, static_argnames=("causal", "window"))
    uncertainty_ref = jax.jit(_unc_ref, static_argnames="k")

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, jnp.float32).astype(getattr(jnp, dtype))
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        DTYPES[dtype])


def _torch(a: np.ndarray, dtype: str) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(DTYPES[dtype])


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(a, b, tol):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


def _with_pallas(dtype: str, case: tuple, sweep: list) -> bool:
    """Pallas interpret mode is slow in bf16: hold every f32 case to the
    Pallas kernel, and the first case of each sweep in bf16 (every bf16 case
    is still held to the jitted oracle)."""
    return dtype == "float32" or case == sweep[0]


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the chip)")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# uncertainty (Eq. 2-3)
# ---------------------------------------------------------------------------

UNC_SWEEP = [(2, 16, 4096, 8, 1024, 10), (1, 8, 512, 8, 128, 5),
             (3, 32, 8192, 8, 2048, 16), (1, 8, 1024, 4, 256, 1)]


class TestUncertainty:
    @pytest.mark.parametrize("B,N,V,bn,bv,k", UNC_SWEEP)
    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    def test_plain_matches_jax(self, B, N, V, bn, bv, k, dtype):
        rng = np.random.default_rng(B * 1000 + V)
        lj, lt = _pair(rng.standard_normal((B, N, V)) * 3, dtype)
        tok = rng.integers(0, V, (B, N)).astype(np.int32)
        out = uops.uncertainty(lt, torch.from_numpy(tok), k=k)
        tol = 1e-4 if dtype == "float32" else 2e-2
        for o, r, t in zip(out, uncertainty_ref(lj, jnp.asarray(tok), k=k),
                           (tol, 5e-3, tol)):
            _close(o, r, t)
        if _with_pallas(dtype, (B, N, V, bn, bv, k), UNC_SWEEP):
            for o, p, t in zip(out, uncertainty_pallas(
                    lj, jnp.asarray(tok), k=k, bn=bn, bv=bv, interpret=True),
                    (tol, 5e-3, tol)):
                _close(o, p, t)

    def test_duplicate_topk_values_are_kept(self):
        """Ties count once per occurrence: the top-4 of [9, 9, 9, 1, ...] is
        [9, 9, 9, 1] (variance 12), as lax.top_k and the Pallas kernel."""
        V = 256
        row = np.full((1, 1, V), -3.0, np.float32)
        row[0, 0, [5, 77, 200]] = 9.0
        row[0, 0, 130] = 1.0
        tok = np.array([[77]], np.int32)
        h, v, hd = uops.uncertainty(torch.from_numpy(row),
                                    torch.from_numpy(tok), k=4)
        np.testing.assert_allclose(v.numpy(), [[12.0]], rtol=1e-6)
        for o, r in zip((h, v, hd), uncertainty_pallas(
                jnp.asarray(row), jnp.asarray(tok), k=4, bv=128,
                interpret=True)):
            _close(o, r, 1e-5)

    def test_extreme_logits_stable(self):
        logits = np.full((1, 8, 512), -1e4, np.float32)
        logits[..., 0] = 1e4
        tok = np.zeros((1, 8), np.int32)
        out = uops.uncertainty(torch.from_numpy(logits),
                               torch.from_numpy(tok), k=4)
        for o, r in zip(out, uncertainty_ref(jnp.asarray(logits),
                                             jnp.asarray(tok), k=4)):
            assert np.isfinite(o.numpy()).all()
            _close(o, r, 1e-4)

    def test_terms_mode_and_counts(self):
        rng = np.random.default_rng(3)
        lt = torch.from_numpy(rng.standard_normal((2, 3, 64)).astype(
            np.float32))
        tok = torch.from_numpy(rng.integers(0, 64, (2, 3)).astype(np.int32))
        uops.counts.reset()
        h, v, hd = uops.uncertainty(lt, tok, k=5)
        ht, vt = uops.uncertainty_terms(lt, tok, k=5, mode="token")
        hdist, _ = uops.uncertainty_terms(lt, tok, k=5, mode="distribution")
        assert torch.equal(ht, h) and torch.equal(vt, v)
        assert torch.equal(hdist, hd)
        assert (uops.counts.launches, uops.counts.plain) == (0, 3)

    @pytest.mark.gpu
    @pytest.mark.parametrize("V", [49152, 128256, 152064])
    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    def test_kernel_matches_plain(self, cuda, V, dtype):
        rng = np.random.default_rng(V)
        lt = _torch(rng.standard_normal((8, 1, V)) * 3, dtype)
        lt[0, 0, :12] = lt[0, 0].max()            # duplicate top-k values
        tok = torch.from_numpy(rng.integers(0, V, (8, 1)).astype(np.int32))
        # rows 0-3 choose a likely token (one of row 0's tied maxima, row 1's
        # argmax, rows 2-3's 2nd and 5th largest): Eq. 2's -p log p is then
        # ~0.1, not the ~1e-6 of a random token, and is held at a relative
        # tolerance, so a wrong chosen logit or log p cannot pass
        top = torch.topk(lt[:, 0].float(), 5, dim=-1).indices
        tok[0, 0] = 3
        tok[1:4, 0] = top[[1, 2, 3], [0, 1, 4]].to(torch.int32)
        out = uops.uncertainty(lt.to(cuda), tok.to(cuda), k=10)
        ref = uref.uncertainty_ref(lt, tok, k=10)
        assert float(ref[0][:4].min()) > 1e-3
        torch.testing.assert_close(out[0].cpu(), ref[0], rtol=1e-4, atol=1e-7)
        for o, r, t in zip(out[1:], ref[1:], (5e-3, 1e-4)):
            _close(o.cpu(), r, t)


# ---------------------------------------------------------------------------
# positions-mode flash attention (prefill)
# ---------------------------------------------------------------------------

FLASH_SWEEP = [(2, 256, 4, 2, 64, True, None), (1, 128, 8, 8, 32, False, None),
               (2, 256, 6, 2, 64, True, 64), (1, 512, 4, 1, 128, True, None)]


def _flash_inputs(B, S, T, H, K, D, dtype, seed):
    rng = np.random.default_rng(seed)
    q = _pair(rng.standard_normal((B, S, H, D)), dtype)
    k = _pair(rng.standard_normal((B, T, K, D)), dtype)
    v = _pair(rng.standard_normal((B, T, K, D)), dtype)
    return q, k, v


class TestFlashPositions:
    @pytest.mark.parametrize("B,S,H,K,D,causal,window", FLASH_SWEEP)
    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    def test_plain_matches_jax(self, B, S, H, K, D, causal, window, dtype):
        (qj, qt), (kj, kt), (vj, vt) = _flash_inputs(B, S, S, H, K, D,
                                                     dtype, S + H)
        pos = np.arange(S, dtype=np.int32)
        kw = dict(causal=causal, window=window)
        out = fops.flash_attention_positions(
            qt, kt, vt, q_positions=torch.from_numpy(pos),
            kv_positions=torch.from_numpy(pos), **kw)
        ref = flash_attention_positions_ref(
            qj, kj, vj, q_positions=jnp.asarray(pos),
            kv_positions=jnp.asarray(pos), **kw)
        tol = 2e-5 if dtype == "float32" else 2e-2
        _close(out, ref, tol)
        if _with_pallas(dtype, (B, S, H, K, D, causal, window), FLASH_SWEEP):
            _close(out, flash_attention_positions_pallas(
                qj, kj, vj, q_positions=jnp.asarray(pos),
                kv_positions=jnp.asarray(pos), bq=min(S, 256),
                bk=min(S, 256), interpret=True, **kw), tol)

    @pytest.mark.parametrize("window", [None, 8])
    def test_live_cache_layout(self, window):
        """Span at positions 20..27 over a cache holding 0..27, tail slots
        empty (-1): the continuation layout of the reference's sweep."""
        B, S, T, H, K, D = 2, 8, 32, 4, 2, 32
        (qj, qt), (kj, kt), (vj, vt) = _flash_inputs(B, S, T, H, K, D,
                                                     "float32", 7)
        qpos = np.arange(20, 20 + S, dtype=np.int32)
        kvpos = np.where(np.arange(T) < 28, np.arange(T), -1).astype(np.int32)
        out = fops.flash_attention_positions(
            qt, kt, vt, q_positions=torch.from_numpy(qpos),
            kv_positions=torch.from_numpy(kvpos), window=window)
        pal = flash_attention_positions_pallas(
            qj, kj, vj, q_positions=jnp.asarray(qpos),
            kv_positions=jnp.asarray(kvpos), window=window, bq=4, bk=8,
            interpret=True)
        _close(out, pal, 2e-5)

    def test_padding_rows_are_mean_of_v(self):
        """Bucket-padding queries (negative positions) see no valid key: the
        finite -1e30 fill makes them a uniform softmax, i.e. mean(v) over
        every slot — finite, never NaN."""
        B, S, H, K, D = 1, 16, 3, 1, 16
        (qj, qt), (kj, kt), (vj, vt) = _flash_inputs(B, S, S, H, K, D,
                                                     "float32", 11)
        pos = (np.arange(S) - 5).astype(np.int32)          # 5 padding rows
        out = fops.flash_attention_positions(
            qt, kt, vt, q_positions=torch.from_numpy(pos),
            kv_positions=torch.from_numpy(pos))
        assert torch.isfinite(out).all()
        mean_v = vt.mean(dim=1)                            # (B, K, D)
        for h in range(H):
            torch.testing.assert_close(
                out[:, :5, h], mean_v[:, None, h // (H // K)].expand(B, 5, D),
                rtol=1e-6, atol=1e-6)
        ref = flash_attention_positions_ref(
            qj, kj, vj, q_positions=jnp.asarray(pos),
            kv_positions=jnp.asarray(pos))
        _close(out, ref, 2e-5)

    def test_gqa_head_mapping(self):
        """Head h reads KV head h // G for G that is not a power of two."""
        B, S, H, K, D = 1, 8, 9, 3, 16
        (_, qt), (_, kt), (_, vt) = _flash_inputs(B, S, S, H, K, D,
                                                  "float32", 5)
        pos = torch.arange(S, dtype=torch.int32)
        out = fops.flash_attention_positions(qt, kt, vt, q_positions=pos,
                                             kv_positions=pos)
        for h in range(H):
            one = fops.flash_attention_positions(
                qt[:, :, h:h + 1].contiguous(),
                kt[:, :, h // 3:h // 3 + 1].contiguous(),
                vt[:, :, h // 3:h // 3 + 1].contiguous(),
                q_positions=pos, kv_positions=pos)
            torch.testing.assert_close(out[:, :, h:h + 1], one)

    def test_packed_shape_matches_jax(self):
        """The gateway-like shape the card runs with packed GQA row tiles
        (S * G = 64 rows of one KV head in one tile), 2 padding columns:
        the plain version against the JAX oracle and interpret-mode
        Pallas."""
        B, S, H, K, D = 4, 8, 16, 2, 128
        (qj, qt), (kj, kt), (vj, vt) = _flash_inputs(B, S, S, H, K, D,
                                                     "float32", 13)
        pos = (np.arange(S) - 2).astype(np.int32)
        out = fops.flash_attention_positions(
            qt, kt, vt, q_positions=torch.from_numpy(pos),
            kv_positions=torch.from_numpy(pos))
        jpos = jnp.asarray(pos)
        _close(out, flash_attention_positions_ref(
            qj, kj, vj, q_positions=jpos, kv_positions=jpos), 2e-5)
        _close(out, flash_attention_positions_pallas(
            qj, kj, vj, q_positions=jpos, kv_positions=jpos, bq=8, bk=8,
            interpret=True), 2e-5)

    @pytest.mark.gpu
    @pytest.mark.parametrize("B,S,T,H,K,D,layout,window", [
        (8, 128, 128, 9, 3, 64, "pad7", None),
        (2, 256, 256, 32, 8, 128, "pad7", None),
        (1, 100, 100, 4, 2, 64, "pad7", None),
        (4, 8, 8, 64, 8, 128, "pad2", None),        # packed, G=8
        (4, 12, 320, 16, 2, 128, "continuation", None),   # packed, 96 rows
        (16, 12, 320, 9, 3, 64, "continuation", 64),
        (1, 130, 300, 4, 2, 64, "tail", None),     # ragged against BK
        (1, 300, 300, 8, 2, 64, "pad7", 100),      # window across tiles
        (2, 70, 70, 4, 2, 16, "pad7", None),       # D = 16
        (2, 70, 70, 4, 4, 32, "pad7", None),       # D = 32
        (1, 200, 200, 4, 2, 256, "pad7", None),    # D = 256
    ])
    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    def test_kernel_matches_plain(self, cuda, B, S, T, H, K, D, layout,
                                  window, dtype):
        """Layouts: ``padN`` a cold prefill with N left-padding rows;
        ``continuation`` a warm span at positions 300..311 over a 320-slot
        cache with empty (-1) slots in the middle and at the tail; ``tail``
        the last S positions of a full cache."""
        rng = np.random.default_rng(S + T)
        qt = _torch(rng.standard_normal((B, S, H, D)), dtype)
        kt = _torch(rng.standard_normal((B, T, K, D)), dtype)
        vt = _torch(rng.standard_normal((B, T, K, D)), dtype)
        if layout.startswith("pad"):
            qpos = kvpos = torch.arange(S, dtype=torch.int32) - int(
                layout[3:])
        elif layout == "continuation":
            kvpos = torch.arange(T, dtype=torch.int32)
            kvpos[100:140] = -1
            kvpos[312:] = -1
            qpos = torch.arange(300, 300 + S, dtype=torch.int32)
        else:
            kvpos = torch.arange(T, dtype=torch.int32)
            qpos = kvpos[T - S:].clone()
        kw = dict(window=window)
        fops.counts.reset()
        out = fops.flash_attention_positions(
            qt.to(cuda), kt.to(cuda), vt.to(cuda), q_positions=qpos.to(cuda),
            kv_positions=kvpos.to(cuda), **kw)
        torch.cuda.synchronize()
        assert fops.counts.launches == 1 and fops.counts.plain == 0
        ref = fref.flash_attention_positions_ref(qt, kt, vt, q_positions=qpos,
                                                 kv_positions=kvpos, **kw)
        _close(out.cpu(), ref, 2e-5 if dtype == "float32" else 2e-2)


# ---------------------------------------------------------------------------
# monolithic decode attention
# ---------------------------------------------------------------------------

DECODE_SWEEP = [(2, 512, 2, 4, 64, None, 128), (1, 256, 4, 1, 32, 64, 64),
                (3, 1024, 2, 2, 64, None, 256), (1, 128, 1, 8, 128, None, 128)]


def _decode_inputs(B, T, K, G, D, dtype, seed):
    rng = np.random.default_rng(seed)
    q = _pair(rng.standard_normal((B, K, G, D)), dtype)
    k = _pair(rng.standard_normal((B, T, K, D)), dtype)
    v = _pair(rng.standard_normal((B, T, K, D)), dtype)
    idx = rng.integers(T // 2, T, (B,)).astype(np.int32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
    pos = np.where(pos <= idx[:, None], pos, -1).astype(np.int32)
    return q, k, v, pos, idx


class TestDecodeAttention:
    @pytest.mark.parametrize("B,T,K,G,D,window,bt", DECODE_SWEEP)
    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    def test_plain_matches_jax(self, B, T, K, G, D, window, bt, dtype):
        (qj, qt), (kj, kt), (vj, vt), pos, idx = _decode_inputs(
            B, T, K, G, D, dtype, T + G)
        out = dops.decode_attention(qt, kt, vt, torch.from_numpy(pos),
                                    torch.from_numpy(idx), window=window)
        args = (qj, kj, vj, jnp.asarray(pos), jnp.asarray(idx))
        tol = 2e-5 if dtype == "float32" else 2e-2
        _close(out, decode_attention_ref(*args, window=window), tol)
        if _with_pallas(dtype, (B, T, K, G, D, window, bt), DECODE_SWEEP):
            _close(out, decode_attention_pallas(
                *args, window=window, bt=max(bt, 256), interpret=True), tol)

    def test_empty_slots_never_attended_and_empty_row_is_mean(self):
        B, T, K, G, D = 2, 64, 1, 3, 16
        rng = np.random.default_rng(0)
        q = torch.from_numpy(rng.standard_normal((B, K, G, D)).astype(
            np.float32))
        k = torch.full((B, T, K, D), 1e3)                  # poison
        v = torch.full((B, T, K, D), 1e3)
        k[:, :4] = torch.from_numpy(rng.standard_normal((B, 4, K, D)).astype(
            np.float32))
        v[:, :4] = torch.from_numpy(rng.standard_normal((B, 4, K, D)).astype(
            np.float32))
        pos = torch.full((B, T), -1, dtype=torch.int32)
        pos[0, :4] = torch.arange(4, dtype=torch.int32)
        idx = torch.tensor([3, 3], dtype=torch.int32)
        out = dops.decode_attention(q, k, v, pos, idx)
        assert float(out[0].abs().max()) < 50.0            # poison unseen
        # row 1 has no valid slot: uniform over all T slots, finite
        assert torch.isfinite(out).all()
        torch.testing.assert_close(out[1], v[1].mean(0)[:, None, :].expand(
            K, G, D))

    def test_counts_plain_calls(self):
        (_, qt), (_, kt), (_, vt), pos, idx = _decode_inputs(
            1, 32, 1, 2, 16, "float32", 1)
        dops.counts.reset()
        dops.decode_attention(qt, kt, vt, torch.from_numpy(pos),
                              torch.from_numpy(idx))
        assert (dops.counts.launches, dops.counts.plain) == (0, 1)

    def test_wrapper_rejects_bad_operands(self):
        (_, qt), (_, kt), (_, vt), pos, idx = _decode_inputs(
            1, 32, 1, 2, 16, "float32", 1)
        with pytest.raises(TypeError):
            dops.decode_attention(qt, kt, vt, torch.from_numpy(pos).long(),
                                  torch.from_numpy(idx))
        with pytest.raises(ValueError):
            dops.decode_attention(qt, kt[:, :16], vt, torch.from_numpy(pos),
                                  torch.from_numpy(idx))

    @pytest.mark.gpu
    @pytest.mark.parametrize("B,T,K,G,D,fill", [
        (8, 256, 3, 3, 64, "half"), (8, 256, 8, 4, 128, "half"),
        (3, 100, 2, 8, 64, "half"),
        # splits over keys: B=1 and B=8, T up to 2048 (row 0 of every case
        # sees no key, so the B=2 case is a split launch with such a row)
        (1, 2048, 8, 4, 128, "half"), (2, 2048, 8, 4, 128, "half"),
        (8, 2048, 3, 3, 64, "half"), (8, 320, 3, 3, 64, "half"),
        # the gateway's fill: index 8-15 of 128 slots, most tiles empty
        (50, 128, 3, 3, 64, "gateway"), (50, 128, 8, 8, 128, "gateway"),
        # G 8 and 16 at D 128; D 32 and 256
        (4, 256, 2, 8, 128, "half"), (2, 300, 1, 16, 128, "half"),
        (3, 100, 2, 8, 32, "half"), (2, 512, 2, 4, 256, "half")])
    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    def test_kernel_matches_plain(self, cuda, B, T, K, G, D, fill, dtype):
        rng = np.random.default_rng(T)
        qt = _torch(rng.standard_normal((B, K, G, D)), dtype)
        kt = _torch(rng.standard_normal((B, T, K, D)), dtype)
        vt = _torch(rng.standard_normal((B, T, K, D)), dtype)
        lo, hi = (T // 2, T) if fill == "half" else (8, 16)
        it = torch.from_numpy(rng.integers(lo, hi, (B,)).astype(np.int32))
        ar = torch.arange(T, dtype=torch.int32)
        pt = torch.where(ar[None] <= it[:, None], ar[None], -1).to(
            torch.int32)
        if fill == "gateway":
            pt[:, :2] = -1                           # bucket padding
        pt[0] = -1                                   # a row with no valid slot
        dops.counts.reset()
        out = dops.decode_attention(qt.to(cuda), kt.to(cuda), vt.to(cuda),
                                    pt.to(cuda), it.to(cuda))
        torch.cuda.synchronize()
        assert dops.counts.launches == 1
        ref = dref.decode_attention_ref(qt, kt, vt, pt, it)
        _close(out.cpu(), ref, 2e-5 if dtype == "float32" else 2e-2)


def test_blocking_matches_reference():
    for dim in (64, 192, 320, 640, 1280, 49152, 128256, 152064, 202048):
        for cap in (8, 256, 512, 2048):
            assert blocking.snap_block(dim, cap) == jblocking.snap_block(
                dim, cap)
        assert blocking.decode_blocks(dim) == jblocking.decode_blocks(dim)
        assert blocking.flash_blocks(dim, dim) == jblocking.flash_blocks(
            dim, dim)
        assert blocking.uncertainty_blocks(8, dim) == \
            jblocking.uncertainty_blocks(8, dim)
    with pytest.raises(ValueError):
        blocking.snap_block(0, 8)


# ---------------------------------------------------------------------------
# no backward: every entry point refuses operands that require grad
# ---------------------------------------------------------------------------

def _guarded_call(name: str, device, requires_grad: bool):
    """(launch counts, a call of entry point ``name``) on small bf16
    operands on ``device``, every float operand with ``requires_grad``."""
    g = torch.Generator().manual_seed(0)

    def f(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g).to(
            device=device, dtype=dtype).requires_grad_(requires_grad)

    def i32(vals):
        return torch.tensor(vals, dtype=torch.int32, device=device)

    B, S, H, K, D = 2, 8, 4, 2, 16
    if name == "flash_attention_positions":
        q, k, v, pos = f(B, S, H, D), f(B, S, K, D), f(B, S, K, D), \
            i32(list(range(S)))
        return fops.counts, lambda: fops.flash_attention_positions(
            q, k, v, q_positions=pos, kv_positions=pos)
    if name == "flash_attention":
        q, k, v = f(B, S, H, D), f(B, S, K, D), f(B, S, K, D)
        return fops.grid_counts, lambda: fops.flash_attention(q, k, v)
    if name == "decode_attention":
        q, k, v = f(B, K, H // K, D), f(B, S, K, D), f(B, S, K, D)
        pos, idx = i32([list(range(S))] * B), i32([S - 1] * B)
        return dops.counts, lambda: dops.decode_attention(q, k, v, pos, idx)
    if name == "paged_decode_attention":
        N, L, nb = 4, 16, 2
        q, kp, vp = f(B, K, H // K, D), f(N, L, K, D), f(N, L, K, D)
        pos = i32([list(range(L))] * N)
        table, idx = i32([[0, 1], [2, 3]]), i32([L - 1] * B)
        return dops.paged_counts, lambda: dops.paged_decode_attention(
            q, kp, vp, pos, table, idx)
    logits, tok = f(B, 1, 512, dtype=torch.float32), i32([[3], [7]])
    return uops.counts, lambda: uops.uncertainty(logits, tok, k=10)


GUARDED = ("flash_attention_positions", "flash_attention", "decode_attention",
           "paged_decode_attention", "swarm_uncertainty")


def _check_refuses_autograd(name: str, device):
    counts, call = _guarded_call(name, device, True)
    counts.reset()
    with pytest.raises(RuntimeError, match="has no backward"):
        call()
    assert counts.launches == counts.plain == 0
    with torch.no_grad():
        call()
    _, frozen = _guarded_call(name, device, False)
    frozen()                             # grad mode, no operand needs grad
    return counts


@pytest.mark.parametrize("name", GUARDED)
def test_wrappers_refuse_autograd(name):
    """On the CPU: the refusal comes before the plain version runs; under
    no_grad, or with no operand that requires grad, the call goes
    through."""
    counts = _check_refuses_autograd(name, torch.device("cpu"))
    assert counts.plain == 2 and counts.launches == 0


@pytest.mark.gpu
@pytest.mark.parametrize("name", GUARDED)
def test_kernels_refuse_autograd(cuda, name):
    """On the card: no launch for operands that require grad in grad
    mode; the same operands launch under no_grad."""
    counts = _check_refuses_autograd(name, cuda)
    torch.cuda.synchronize()
    assert counts.launches == 2 and counts.plain == 0
