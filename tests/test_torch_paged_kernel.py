"""Kernel 5, the block-table decode (``kernels.decode_attention.ops.
paged_decode_attention``), against the JAX package's oracle
(``paged_decode_attention_ref``) and its Pallas kernel in interpret mode.

On the CPU the wrapper runs its plain version, which these tests hold to
both, on the same numpy-seeded operands, in f32 to 2e-6 (the reference's
own tolerance between its oracle and its kernel, tests/test_paged_cache.py):
window None and 16; with and without delta rows (linear covered slots, ring
covered slots, a dispatch longer than the ring); sentinel table entries;
two rows sharing a block; int8 and fp8 pools with scales (fp8 crosses as a
uint8 view).  The tests marked ``gpu`` hold the CUDA kernel to the plain
version on the card: f32 to 2e-5 and bf16 to 2e-2 (summation order; the
bf16 output is rounded), for bf16, int8 and fp8 pools.

A row that sees no key at all averages V: over every gathered slot in the
plain version (clamped sentinel blocks included), over the blocks it visits
in the kernel (sentinels are skipped).  Serving rows always see their own
delta row; the tests below pin both behaviours down.
"""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # parallel pytest workers share the cores

from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.models import quant as TQ

try:        # the JAX reference; a CUDA machine without JAX runs -m gpu only
    import jax
    import jax.numpy as jnp

    from repro.kernels.decode_attention.ops import \
        paged_decode_attention as jax_paged
    from repro.models import quant as JQ
except ImportError:
    jax = None


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the chip)")
    return torch.device("cuda")


def paged_case(B=3, K=2, G=4, D=16, N=14, L=8, nb=4, *, S=0, window=None,
               sentinel=False, share=False, seed=0):
    """numpy operands of one paged decode step.  Row b is at position
    ``idx[b]``.  With ``S`` delta rows the dispatch started at ``p0[b]``
    and its rows p0..idx are in the delta buffer (odd rows one step
    behind, so their last delta row is unwritten).  The pool holds the
    slots' contents from before the dispatch; linear slots the dispatch
    rewrote hold a stale row at a plausible position, so only the covered
    mask keeps them out.  ``window`` = a ring layer over the nb*L slots of
    the table (slot = position mod nb*L)."""
    rng = np.random.default_rng(seed)
    Tl = nb * L
    q = rng.standard_normal((B, K, G, D)).astype(np.float32)
    kp = rng.standard_normal((N, L, K, D)).astype(np.float32)
    vp = rng.standard_normal((N, L, K, D)).astype(np.float32)
    table = rng.permutation(N)[:B * nb].reshape(B, nb).astype(np.int32)
    if share:
        table[1, 0] = table[0, 0]          # two rows read one prefix block
    top = 3 * Tl if window is not None else Tl - 1
    idx = np.linspace(top, max(S, 3), B).astype(np.int32)
    steps = np.maximum(S - 1 - np.arange(B) % 2, 0)
    p0 = (idx - steps if S else idx + 1).astype(np.int32)
    pos_pool = np.full((N, L), -1, np.int32)
    for b in range(B):
        for s in range(Tl):
            if window is None:             # linear: slot s holds position s
                p = s if s <= idx[b] else -1
            else:                          # ring: the latest p < p0 at s
                p = s + Tl * ((int(p0[b]) - 1 - s) // Tl)
            pos_pool[table[b, s // L], s % L] = max(p, -1)
    if share:                              # both rows see slots 0..L-1
        pos_pool[table[0, 0]] = np.arange(L)
    if sentinel:
        table[0, -1] = N                   # row 0's tail: an empty entry
    out = dict(q=q, kp=kp, vp=vp, pos=pos_pool, table=table, idx=idx,
               window=window)
    if S:
        dk = rng.standard_normal((B, S, K, D)).astype(np.float32)
        dv = rng.standard_normal((B, S, K, D)).astype(np.float32)
        dpos = np.full((B, S), -1, np.int32)
        for b in range(B):
            n = int(steps[b]) + 1
            dpos[b, :n] = p0[b] + np.arange(n)
        out.update(dk=dk, dv=dv, dpos=dpos, p0=p0)
    return out


def _quantize(c, quant):
    """Quantize the pool through JAX's quantize_rows: returns the numpy
    payload (fp8 as a uint8 view) and scales."""
    out = {}
    for name in ("kp", "vp"):
        qv, sc = JQ.quantize_rows(jnp.asarray(c[name], jnp.bfloat16), quant)
        qn = np.asarray(qv.view(jnp.uint8) if quant == "fp8" else qv)
        out[name] = (qn, np.asarray(sc))
    return out


def _torch_quant(qn, quant):
    t = torch.from_numpy(qn.copy())
    return t.view(torch.float8_e4m3fn) if quant == "fp8" else t


def _port(c, dtype=torch.float32, pools=None, device="cpu"):
    """The port's call on case ``c``; ``pools`` = quantized (k, ks, v, vs)
    torch tensors."""
    def t(a, dt=None):
        x = torch.from_numpy(np.ascontiguousarray(a))
        return (x.to(dt) if dt is not None else x).to(device)
    kw = dict(window=c["window"])
    if pools is not None:
        kq, ks, vq, vs = (p.to(device) for p in pools)
        kw.update(k_scale=ks, v_scale=vs)
    else:
        kq, vq = t(c["kp"], dtype), t(c["vp"], dtype)
    if "dk" in c:
        kw.update(delta_k=t(c["dk"], dtype), delta_v=t(c["dv"], dtype),
                  delta_pos=t(c["dpos"]), p0=t(c["p0"]))
    return dops.paged_decode_attention(t(c["q"], dtype), kq, vq,
                                       t(c["pos"]), t(c["table"]),
                                       t(c["idx"]), **kw)


def _jax(c, pools=None, force_pallas=False):
    kw = dict(window=c["window"], force_pallas=force_pallas)
    kp, vp = jnp.asarray(c["kp"]), jnp.asarray(c["vp"])
    if pools is not None:
        (kp, kw["k_scale"]), (vp, kw["v_scale"]) = pools
    if "dk" in c:
        kw.update(delta_k=jnp.asarray(c["dk"]), delta_v=jnp.asarray(c["dv"]),
                  delta_pos=jnp.asarray(c["dpos"]), p0=jnp.asarray(c["p0"]))
    return np.asarray(jax_paged(jnp.asarray(c["q"]), kp, vp,
                                jnp.asarray(c["pos"]),
                                jnp.asarray(c["table"]),
                                jnp.asarray(c["idx"]), **kw))


# ring cases: a view of nb*L = 8 slots under a window of 16, where a slot's
# pre-wrap row can still pass the window test and only the covered mask
# keeps it out
RING = dict(window=16, nb=2, L=4)
CASES = {
    "pool": dict(),
    "pool-window": dict(window=16),
    "linear-delta": dict(S=5),
    "ring-delta": dict(S=5, **RING),
    "ring-longer-than-ring": dict(S=21, **RING),
    "sentinel": dict(S=3, sentinel=True),
    "shared-block": dict(S=2, share=True),
    "ring-sentinel": dict(S=4, sentinel=True, **RING),
}


@pytest.mark.skipif("jax is None")
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_jax_ref_and_pallas(name):
    c = paged_case(**CASES[name])
    out = _port(c).numpy()
    np.testing.assert_allclose(out, _jax(c), atol=2e-6, rtol=1e-6)
    np.testing.assert_allclose(out, _jax(c, force_pallas=True), atol=2e-6,
                               rtol=1e-6)


@pytest.mark.skipif("jax is None")
@pytest.mark.parametrize("quant", ["int8", "fp8"])
@pytest.mark.parametrize("name", ["pool", "ring-delta", "sentinel"])
def test_quantized_plain_matches_jax(quant, name):
    """int8/fp8 pools with per-row scales: the port's plain version (f32
    dequantized view) against JAX's oracle (the same view) to 2e-6 and its
    fused-scale Pallas kernel to 2e-6; fp8 crosses as a uint8 view."""
    c = paged_case(**CASES[name])
    jq = _quantize(c, quant)
    pools = (_torch_quant(jq["kp"][0], quant), torch.from_numpy(jq["kp"][1]),
             _torch_quant(jq["vp"][0], quant), torch.from_numpy(jq["vp"][1]))
    jpools = tuple((jnp.asarray(qn).view(jnp.float8_e4m3fn)
                    if quant == "fp8" else jnp.asarray(qn), jnp.asarray(sc))
                   for qn, sc in (jq["kp"], jq["vp"]))
    out = _port(c, pools=pools).numpy()
    np.testing.assert_allclose(out, _jax(c, jpools), atol=2e-6, rtol=1e-6)
    np.testing.assert_allclose(out, _jax(c, jpools, force_pallas=True),
                               atol=2e-6, rtol=1e-6)


def test_row_without_key_is_mean_over_gathered_slots():
    """Plain version: a row with no valid key (index below every cached
    position, no delta rows) is the mean of V over all nb*L gathered slots,
    the sentinel entry's clamped block included."""
    c = paged_case(B=2, nb=3, sentinel=True)
    c["idx"][:] = -1
    out = _port(c)
    N = c["kp"].shape[0]
    for b in range(2):
        ids = np.minimum(c["table"][b], N - 1)
        mv = c["vp"][ids].reshape(-1, *c["vp"].shape[2:]).mean(0)  # (K, D)
        np.testing.assert_allclose(out[b].numpy(),
                                   np.broadcast_to(mv[:, None], out[b].shape),
                                   atol=1e-6)


def test_counts_plain_calls_and_refuses_bad_operands():
    c = paged_case(S=2)
    dops.paged_counts.reset()
    _port(c)
    assert (dops.paged_counts.launches, dops.paged_counts.plain) == (0, 1)
    t = {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in c.items() if isinstance(v, np.ndarray)}
    args = (t["q"], t["kp"], t["vp"], t["pos"], t["table"], t["idx"])
    with pytest.raises(TypeError):                 # int64 table
        dops.paged_decode_attention(*args[:4], t["table"].long(), t["idx"])
    with pytest.raises(ValueError):                # pool not (N, L, K, D)
        dops.paged_decode_attention(t["q"], t["kp"][:, :, :1], t["vp"],
                                    *args[3:])
    with pytest.raises(TypeError):                 # int8 pool, no scales
        dops.paged_decode_attention(t["q"], t["kp"].to(torch.int8),
                                    t["vp"].to(torch.int8), *args[3:])
    with pytest.raises(ValueError):                # half the delta operands
        dops.paged_decode_attention(*args, delta_k=t["dk"])
    with pytest.raises(TypeError):                 # delta in another dtype
        dops.paged_decode_attention(*args, delta_k=t["dk"].bfloat16(),
                                    delta_v=t["dv"].bfloat16(),
                                    delta_pos=t["dpos"], p0=t["p0"])
    with pytest.raises(ValueError):                # scales of wrong shape
        dops.paged_decode_attention(
            t["q"], t["kp"].to(torch.int8), t["vp"].to(torch.int8),
            *args[3:], k_scale=torch.ones(3), v_scale=torch.ones(3))


# ---------------------------------------------------------------------------
# the CUDA kernel against the plain version, on the card
# ---------------------------------------------------------------------------

# B, K, G, D: every shape splits over its 4 table entries (B*K < 132); G 8
# and 16 at D 128, D 32 and 256
GPU_SHAPES = [(8, 3, 3, 64), (4, 8, 4, 128), (3, 2, 8, 32), (2, 1, 16, 128),
              (2, 2, 4, 256)]
# beyond CASES: eight table entries (up to 8 splits), a 160-row dispatch
# over a 128-slot ring under a window of 128, and rows with no valid key
# (index below every position) in a split launch
GPU_CASES = {**CASES, "eight-entries": dict(nb=8, S=8),
             "ring-160": dict(S=160, window=128, nb=2, L=64),
             "no-key": dict(S=0, no_key=True)}


def _torch_pools(c, quant, device):
    """Quantize with the port's own helper (the card has no JAX)."""
    out = []
    for name in ("kp", "vp"):
        qv, sc = TQ.quantize_rows(
            torch.from_numpy(c[name]).to(torch.bfloat16), quant)
        out += [qv.to(device), sc.to(device)]
    return out[0], out[1], out[2], out[3]


@pytest.mark.gpu
@pytest.mark.parametrize("pool", ["float32", "bfloat16", "int8", "fp8"])
@pytest.mark.parametrize("name", sorted(GPU_CASES))
@pytest.mark.parametrize("B,K,G,D", GPU_SHAPES)
def test_kernel_matches_plain(cuda, B, K, G, D, name, pool):
    kw = {"nb": 4, "L": 64 if D != 32 else 8, **GPU_CASES[name]}
    no_key = kw.pop("no_key", False)
    c = paged_case(B=B, K=K, G=G, D=D, N=B * kw["nb"] + 4, **kw)
    if no_key:                  # no sentinel here, so the plain version's
        c["idx"][:] = -1        # mean and the kernel's cover the same slots
    dtype = torch.float32 if pool == "float32" else torch.bfloat16
    pools = None
    if pool in ("int8", "fp8"):
        pools = _torch_pools(c, pool, "cpu")
    dops.paged_counts.reset()
    out = _port(c, dtype, pools, device=cuda)
    torch.cuda.synchronize()
    assert dops.paged_counts.launches == 1
    ref = _port(c, dtype, pools)
    tol = 2e-5 if pool == "float32" else 2e-2
    torch.testing.assert_close(out.cpu().float(), ref.float(), atol=tol,
                               rtol=tol)


@pytest.mark.gpu
def test_kernel_row_without_key_is_mean_over_visited_blocks(cuda):
    """The kernel skips a sentinel entry without loading it, so a row with
    no valid key averages V over the blocks it visits (here all but the
    sentinel tail), where the plain version also averages the clamped
    sentinel block (``test_row_without_key_is_mean_over_gathered_slots``).
    """
    c = paged_case(B=2, nb=3, sentinel=True)
    c["idx"][:] = -1
    out = _port(c, device=cuda).cpu()
    N = c["kp"].shape[0]
    for b in range(2):
        ids = [i for i in c["table"][b] if i < N]
        mv = c["vp"][ids].reshape(-1, *c["vp"].shape[2:]).mean(0)
        np.testing.assert_allclose(out[b].numpy(),
                                   np.broadcast_to(mv[:, None], out[b].shape),
                                   atol=1e-5)
