"""The port's recurrent mixers (``repro_torch.models.rglru`` and
``repro_torch.models.ssm``) against the JAX package's, module by module,
and the two recurrent smoke models' ``forward`` / ``loss_fn``.

Inputs come from a numpy seed; the JAX mixers' weights are the JAX init,
rescaled so that every product is of size ~1 (each matrix to std
1/sqrt(fan_in), the output projection to half that, norms and biases
perturbed), and copied into the port's modules; the residual inputs have
std 0.5, so a block's outputs stay below ~4, where a bf16 ulp is under the
budget.  Budgets:

* f32: 1e-5 on outputs of size ~1 where the two packages compute the same
  products in the same order up to summation inside a product; 1e-4 where
  a scan is involved: the port's RG-LRU scan is a Hillis-Steele tree and
  the reference's ``associative_scan`` another tree over the same operator,
  and the SSD products contract in another order;
* bf16: 2e-2, the reference's bf16 budget: both round the activations to
  bf16 at the same sites (``u``, ``g``, the conv output, the gated SSD
  output), but a product accumulates in another order and rounds an ulp
  apart;
* ``forward`` (whole models): the JAX forward attends through its chunked
  attention, which rounds q, k, v and p to bf16 even in an f32 model, so
  the hybrid model's f32 logits are held to 5e-3, as the dense models'
  (``test_torch_model.py::test_forward_logits``); the attention-free SSD
  model to 1e-4.

Bucket padding must be inert in the port: a left-padded prefill equals the
unpadded one at the real columns (bitwise for RG-LRU) and leaves the same
state.
"""

import dataclasses

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # parallel pytest workers share the cores

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as C  # noqa: E402
from repro.models import rglru as JR  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.convert import _layer_blocks, from_jax_params  # noqa: E402
from repro_torch.models import rglru as TR  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

# the JAX entry points, jitted: one compile per shape, not an op-by-op trace
j_init_params = jax.jit(JT.init_params, static_argnums=0)
j_forward = jax.jit(JT.forward, static_argnums=1)
j_loss_fn = jax.jit(JT.loss_fn, static_argnums=1)
J = {name: jax.jit(getattr(mod, name), static_argnums=argn,
                   static_argnames=("continuation",) if "prefill" in name
                   else ())
     for mod, name, argn in ((JR, "rglru_block", 2), (JR, "rglru_prefill", 4),
                             (JR, "rglru_decode", 3), (JS, "ssd_block", 2),
                             (JS, "ssd_prefill", 4), (JS, "ssd_decode", 3),
                             (JS, "ssd_scan", 5))}

ARCHS = {"rglru": "recurrentgemma-2b", "ssd": "mamba2-780m"}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
B, S = 3, 24


def _cfgs(arch: str, dtype: str):
    jd, td = DTYPES[dtype]
    return (dataclasses.replace(C.get_smoke(arch), vocab_size=512, dtype=jd),
            dataclasses.replace(TC.get_smoke(arch), vocab_size=512,
                                dtype=td))


def _tol(dtype: str, scan: bool = False) -> float:
    if dtype == "bfloat16":
        return 2e-2
    return 1e-4 if scan else 1e-5


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(t, j, atol, what=""):
    np.testing.assert_allclose(_np(t), _np(j), atol=atol, rtol=0,
                               err_msg=what)


def _mixer(kind: str, dtype: str, seed: int = 0):
    """(jax config, port config, the JAX layer-0 mixer tree, the port
    module with the same weights)."""
    jc, tc = _cfgs(ARCHS[kind], dtype)
    p = j_init_params(jc, jax.random.PRNGKey(seed))
    _, blk, r = next(_layer_blocks(p["stages"], jc))
    rng = np.random.default_rng(seed)
    out = {}
    for name, leaf in blk["mixer"].items():
        a = np.asarray(leaf if r is None else leaf[r], np.float32)
        if a.ndim == 2:                        # to std 1/sqrt(fan_in)
            a = a / a.std() / np.sqrt(a.shape[0])
            if name in ("w_out", "out_proj"):  # the residual branch: ~0.5
                a = 0.5 * a
        elif name in ("norm", "gnorm", "conv_b", "ba", "bx"):
            a = rng.standard_normal(a.shape) * 0.1
        out[name] = jnp.asarray(a, jnp.float32).astype(leaf.dtype)
    mod = (TR.RGLRU if kind == "rglru" else TS.SSD)(tc)
    with torch.no_grad():
        for name, prm in mod.named_parameters():
            prm.copy_(torch.from_numpy(_np(out[name]).copy()).to(prm.dtype))
    return jc, tc, out, mod


def _x(cfg, shape, seed=1):
    """Residual-stream inputs of std 0.5 (the block's pre-norm makes the
    mixer's own activations ~1), so a block's output stays below ~4, where
    one bf16 ulp is under the budget."""
    rng = np.random.default_rng(seed)
    return 0.5 * rng.standard_normal(shape + (cfg.d_model,)).astype(
        np.float32)


def _both(jc, tc, x):
    return (jnp.asarray(x).astype(jc.dtype),
            torch.from_numpy(x).to(tc.dtype))


def _positions(lengths, width, continuation=False, start=0):
    """(B, width) int32: cold rows left-padded, continuation rows
    right-padded from ``start``; padding negative."""
    pos = np.full((len(lengths), width), -1, np.int32)
    for b, n in enumerate(lengths):
        if continuation:
            pos[b, :n] = start + np.arange(n)
            pos[b, n:] = np.arange(n, width) - width
        else:
            pos[b, width - n:] = np.arange(n)
            pos[b, :width - n] = np.arange(width - n) - (width - n)
    return pos


def _state_pair(kind, jc, tc, batch, seed=2):
    """A nonzero carried state, in JAX and in the port, in separate
    buffers: the port writes its state in place, and a JAX array on the
    CPU may alias the numpy buffer it came from (and read it after the
    call returns: JAX dispatches asynchronously)."""
    rng = np.random.default_rng(seed)
    if kind == "rglru":
        js = JR.init_rglru_state(jc, batch)
        ts = TR.init_rglru_state(tc, batch)
    else:
        js = JS.init_ssm_state(jc, batch)
        ts = TS.init_ssm_state(tc, batch)
    leaves = [rng.standard_normal(a.shape).astype(np.float32) * 0.5
              for a in js]
    js = type(js)(*(jnp.asarray(v).astype(a.dtype)
                    for v, a in zip(leaves, js)))
    ts = type(ts)(*(torch.from_numpy(v.copy()).to(a.dtype)
                    for v, a in zip(leaves, ts)))
    return js, ts


def _state_close(ts, js, atol):
    for name, a, b in zip(ts._fields, ts, js):
        assert a.dtype == {jnp.float32: torch.float32,
                           jnp.bfloat16: torch.bfloat16}[b.dtype.type], name
        _close(a, b, atol, name)


# ---------------------------------------------------------------------------
# the conv and the scans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("mode", ["fresh", "prev", "tail_index"])
def test_causal_conv_matches_jax(dtype, mode):
    """``_causal_conv`` with no history, with ``prev`` and with
    ``tail_index`` (right-padded rows of 5, 12 and 20 real columns), and
    ``_causal_conv_step``; outputs and tails."""
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(3)
    Bc, L, Cc, W = 3, 20, 24, 4
    x = rng.standard_normal((Bc, L, Cc)).astype(np.float32)
    w = (rng.standard_normal((W, Cc)) * 0.5).astype(np.float32)
    b = (rng.standard_normal((Cc,)) * 0.1).astype(np.float32)
    prev = rng.standard_normal((Bc, W - 1, Cc)).astype(np.float32)
    ti = np.array([5, 12, 20], np.int32)
    jx = [jnp.asarray(a).astype(jd) for a in (x, w, b, prev)]
    tx = [torch.from_numpy(a).to(td) for a in (x, w, b, prev)]
    kw_j = {"prev": jx[3]} if mode != "fresh" else {}
    kw_t = {"prev": tx[3]} if mode != "fresh" else {}
    if mode == "tail_index":
        kw_j["tail_index"] = jnp.asarray(ti)
        kw_t["tail_index"] = torch.from_numpy(ti)
    oj, tj = JS._causal_conv(*jx[:3], **kw_j)
    ot, tt = TS._causal_conv(*tx[:3], **kw_t)
    _close(ot, oj, _tol(dtype), "out")
    np.testing.assert_array_equal(_np(tt), _np(tj))          # a copy
    oj, tj = JS._causal_conv_step(jx[0][:, :1], *jx[1:3], jx[3])
    ot, tt = TS._causal_conv_step(tx[0][:, :1], *tx[1:3], tx[3])
    _close(ot, oj, _tol(dtype), "step out")
    np.testing.assert_array_equal(_np(tt), _np(tj))


@pytest.mark.parametrize("S_", [1, 2, 7, 64, 100])
def test_linear_scan_matches_associative_scan(S_):
    """The Hillis-Steele scan against ``lax.associative_scan`` over the
    reference's ``combine``, in f32, a in (0, 1)."""
    rng = np.random.default_rng(S_)
    a = rng.uniform(0.5, 1.0, (2, S_, 8)).astype(np.float32)
    b = rng.standard_normal((2, S_, 8)).astype(np.float32)

    def combine(e1, e2):
        return e1[0] * e2[0], e2[0] * e1[1] + e2[1]

    _, hj = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                               jnp.asarray(b)), axis=1)
    ht = TR.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    _close(ht, hj, 1e-5 * max(S_, 8) ** 0.5)


@pytest.mark.parametrize("L,chunk", [(32, 32), (64, 16), (96, 32), (8, 32)])
def test_ssd_scan_with_init_state(L, chunk):
    """The chunked scan, from a zero and from a given state: y and the
    final state, f32."""
    rng = np.random.default_rng(L + chunk)
    Bs, H, P, G, N = 2, 4, 8, 2, 6
    x = rng.standard_normal((Bs, L, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (Bs, L, H)).astype(np.float32)
    A = -rng.uniform(1, 8, (H,)).astype(np.float32)
    Bm = rng.standard_normal((Bs, L, G, N)).astype(np.float32)
    Cm = rng.standard_normal((Bs, L, G, N)).astype(np.float32)
    s0 = rng.standard_normal((Bs, H, P, N)).astype(np.float32)
    for init in (None, s0):
        yj, sj = J["ssd_scan"](*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)),
                             chunk, None if init is None
                             else jnp.asarray(init))
        yt, st = TS.ssd_scan(*(torch.from_numpy(a)
                               for a in (x, dt, A, Bm, Cm)), chunk,
                             None if init is None
                             else torch.from_numpy(init))
        _close(yt, yj, 1e-4, "y")
        _close(st, sj, 1e-4, "state")


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rglru_block_matches_jax(dtype):
    jc, tc, jp, tm = _mixer("rglru", dtype)
    jx, tx = _both(jc, tc, _x(jc, (B, S)))
    _close(TR.rglru_block(tm, tx, tc) - tx.float(),
           J["rglru_block"](jp, jx, jc) - jx.astype(jnp.float32),
           _tol(dtype, scan=True))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("continuation", [False, True])
def test_rglru_prefill_matches_jax(dtype, continuation):
    """Cold (left-padded, zero state) and continuation (right-padded, from
    a carried state) prefill: outputs at the real columns and the state,
    which the port writes in place."""
    jc, tc, jp, tm = _mixer("rglru", dtype)
    jx, tx = _both(jc, tc, _x(jc, (B, S)))
    pos = _positions([S, 17, 5], S, continuation, start=9)
    if continuation:
        js, ts = _state_pair("rglru", jc, tc, B)
    else:
        js, ts = JR.init_rglru_state(jc, B), TR.init_rglru_state(tc, B)
    yj, sj = J["rglru_prefill"](jp, jx, js, jnp.asarray(pos), jc,
                              continuation=continuation)
    h_before = ts.h
    yt, st = TR.rglru_prefill(tm, tx, ts, torch.from_numpy(pos), tc,
                              continuation=continuation)
    assert st.h is h_before                            # written in place
    real = pos >= 0
    _close(yt.float().numpy()[real], _np(yj)[real], _tol(dtype, True))
    _state_close(st, sj, _tol(dtype, True))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rglru_decode_matches_jax(dtype):
    jc, tc, jp, tm = _mixer("rglru", dtype)
    js, ts = _state_pair("rglru", jc, tc, B)
    for step in range(3):
        jx, tx = _both(jc, tc, _x(jc, (B, 1), seed=10 + step))
        yj, js = J["rglru_decode"](jp, jx, js, jc)
        yt, ts = TR.rglru_decode(tm, tx, ts, tc)
        _close(yt, yj, _tol(dtype), f"step {step}")
        _state_close(ts, js, _tol(dtype))


# ---------------------------------------------------------------------------
# SSD
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ssd_block_matches_jax(dtype):
    jc, tc, jp, tm = _mixer("ssd", dtype)
    jx, tx = _both(jc, tc, _x(jc, (B, 64)))                # two chunks
    _close(TS.ssd_block(tm, tx, tc) - tx.float(),
           J["ssd_block"](jp, jx, jc) - jx.astype(jnp.float32),
           _tol(dtype, scan=True))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("continuation", [False, True])
def test_ssd_prefill_matches_jax(dtype, continuation):
    jc, tc, jp, tm = _mixer("ssd", dtype)
    W = 64
    jx, tx = _both(jc, tc, _x(jc, (B, W)))
    pos = _positions([W, 40, 7], W, continuation, start=11)
    if continuation:
        js, ts = _state_pair("ssd", jc, tc, B)
    else:
        js, ts = JS.init_ssm_state(jc, B), TS.init_ssm_state(tc, B)
    yj, sj = J["ssd_prefill"](jp, jx, js, jnp.asarray(pos), jc,
                            continuation=continuation)
    s_before = ts.ssd
    yt, st = TS.ssd_prefill(tm, tx, ts, torch.from_numpy(pos), tc,
                            continuation=continuation)
    assert st.ssd is s_before                          # written in place
    real = pos >= 0
    _close(yt.float().numpy()[real], _np(yj)[real], _tol(dtype, True))
    _state_close(st, sj, _tol(dtype, True))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ssd_decode_matches_jax(dtype):
    jc, tc, jp, tm = _mixer("ssd", dtype)
    js, ts = _state_pair("ssd", jc, tc, B)
    for step in range(3):
        jx, tx = _both(jc, tc, _x(jc, (B, 1), seed=20 + step))
        yj, js = J["ssd_decode"](jp, jx, js, jc)
        yt, ts = TS.ssd_decode(tm, tx, ts, tc)
        _close(yt, yj, _tol(dtype), f"step {step}")
        _state_close(ts, js, _tol(dtype))


# ---------------------------------------------------------------------------
# padding, prefill against decode, whole models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(ARCHS))
def test_bucket_padding_is_inert(kind):
    """A prefill left-padded by 11 columns equals the unpadded one at the
    real columns and leaves the same state: padding's conv input is zero
    and its step is the identity (RG-LRU a=1, b=0; SSD dt=0).  RG-LRU:
    bitwise (a padding element combines exactly as the identity).  SSD:
    the padding adds exact zeros, but the chunk is the whole (longer)
    span, so the products over it are other matrix shapes and sum in
    another order: 1e-6 in f32."""
    jc, tc, jp, tm = _mixer(kind, "float32")
    n, pad = 21, 11
    x = _x(jc, (B, n))
    xp = np.concatenate([np.zeros((B, pad, jc.d_model), np.float32), x], 1)
    outs = []
    for xx, width in ((x, n), (xp, n + pad)):
        st = TT._init_state(tc, kind, B)
        pre = TR.rglru_prefill if kind == "rglru" else TS.ssd_prefill
        y, st = pre(tm, torch.from_numpy(xx), st,
                    torch.from_numpy(_positions([n] * B, width)), tc)
        outs.append((y[:, -n:], st))
    tol = 0.0 if kind == "rglru" else 1e-6
    for a, b in zip((outs[0][0],) + outs[0][1], (outs[1][0],) + outs[1][1]):
        torch.testing.assert_close(a, b, atol=tol, rtol=0)


@pytest.mark.parametrize("kind", sorted(ARCHS))
def test_prefill_then_decode_matches_stepwise(kind):
    """Absorbing a span by prefill and then decoding gives the outputs and
    state that decoding every token does (f32, the scan's budget)."""
    jc, tc, jp, tm = _mixer(kind, "float32")
    x = torch.from_numpy(_x(jc, (B, 9)))
    pre = TR.rglru_prefill if kind == "rglru" else TS.ssd_prefill
    dec = TR.rglru_decode if kind == "rglru" else TS.ssd_decode
    sp = TT._init_state(tc, kind, B)
    yp, sp = pre(tm, x, sp, torch.from_numpy(_positions([9] * B, 9)), tc)
    sd = TT._init_state(tc, kind, B)
    ys = [dec(tm, x[:, t:t + 1], sd, tc)[0] for t in range(9)]
    torch.testing.assert_close(torch.cat(ys, 1), yp, atol=1e-4, rtol=0)
    for a, b in zip(sd, sp):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)


def _model_pair(arch, dtype, seed=0):
    jc, tc = _cfgs(arch, dtype)
    p = j_init_params(jc, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def perturb(a):
        if np.any(np.asarray(a, np.float32)):
            return a
        return jnp.asarray(rng.standard_normal(a.shape) * 0.1,
                           jnp.float32).astype(a.dtype)

    p = jax.tree.map(perturb, p)
    return jc, tc, p, from_jax_params(jax.tree.map(np.asarray, p), tc)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", sorted(ARCHS))
def test_forward_and_loss_match_jax(kind, dtype):
    """``forward`` logits and ``loss_fn``'s loss of both smoke models
    (every layer: the hybrid's rglru/rglru/attn_local periods and its
    remainder, the SSD model's two layers)."""
    jc, tc, p, model = _model_pair(ARCHS[kind], dtype)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 512, (2, 32)).astype(np.int32)
    labels = rng.integers(0, 512, (2, 32)).astype(np.int32)
    batch_j = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    batch_t = {"tokens": torch.from_numpy(toks),
               "labels": torch.from_numpy(labels)}
    tol = (2e-2 if dtype == "bfloat16"
           else 5e-3 if kind == "rglru" else 1e-4)
    lj, _ = j_forward(p, jc, batch_j)
    with torch.no_grad():
        lt, _ = TT.forward(model, tc, batch_t)
    _close(lt, lj, tol)
    loss_j, _ = j_loss_fn(p, jc, batch_j)
    loss_t, _ = TT.loss_fn(model, tc, batch_t)
    assert abs(float(loss_t) - float(loss_j)) < tol


def test_conversion_keeps_the_f32_leaves():
    """A bf16 model keeps ``lam``, ``A_log``, ``dt_bias`` and ``D_skip`` in
    f32, as the JAX tree does; every leaf converts exactly."""
    for arch in ARCHS.values():
        jc, tc, p, model = _model_pair(arch, "bfloat16")
        named = dict(model.named_parameters())
        for layer, blk, r in _layer_blocks(p["stages"], jc):
            for part, sub in blk.items():
                for name, leaf in sub.items():
                    a = np.asarray(leaf if r is None else leaf[r],
                                   np.float32)
                    t = named[f"layers.{layer}.{part}.{name}"]
                    assert t.dtype == {jnp.float32: torch.float32,
                                       jnp.bfloat16: torch.bfloat16}[
                                           leaf.dtype.type], name
                    np.testing.assert_array_equal(t.float().numpy(), a)


@pytest.mark.parametrize("kind", sorted(ARCHS))
def test_init_params_distribution(kind):
    """The port's init draws the reference's distributions for the
    recurrences' own leaves: lam gives a = sigmoid(lam)^8 in [0.9, 0.999],
    A in [1, 16], dt in [1e-3, 0.1], D_skip 1, biases 0."""
    _, tc = _cfgs(ARCHS[kind], "float32")
    m = TT.init_params(tc, torch.Generator().manual_seed(0))
    mix = m.layers[0].mixer
    if kind == "rglru":
        a = torch.sigmoid(mix.lam) ** 8
        assert float(a.min()) >= 0.9 - 1e-6 and float(a.max()) <= 0.999
        assert mix.lam.dtype == torch.float32
        assert float(mix.ba.abs().max()) == 0.0
        std_o = 0.02 / (2 * tc.num_layers) ** 0.5
        assert float(mix.w_out.std()) == pytest.approx(std_o, rel=0.2)
    else:
        A = torch.exp(mix.A_log)
        assert 1.0 <= float(A.min()) and float(A.max()) <= 16.0
        dt = torch.nn.functional.softplus(mix.dt_bias)
        assert 1e-3 - 1e-6 <= float(dt.min()) and float(dt.max()) <= 0.1001
        assert torch.equal(mix.D_skip, torch.ones_like(mix.D_skip))
        assert float(mix.gnorm.abs().max()) == 0.0
