"""Ranks of a gloo world on the CPU for ``test_torch_mesh_engine.py``: the
port's mesh-sharded engine and gateway against its single-device ones.

    python tests/torch_mesh_ranks.py engines   # 4 ranks: (2,2), (1,4), (4,1)
    python tests/torch_mesh_ranks.py gateway   # 2 ranks: (1,2)
    python tests/torch_mesh_ranks.py paged     # 4 ranks: paged and quantized,
                                               # and a (2,2,1) pod mesh
    python tests/torch_mesh_ranks.py lockstep  # 2 ranks: (2,1) pool decisions
    python tests/torch_mesh_ranks.py ckpt DIR  # 4 ranks: sessions, meshes
    python tests/torch_mesh_ranks.py paged_gateway  # 2 ranks: (1,2), int8 pool
    python tests/torch_mesh_ranks.py cli [STEPS]  # 2 ranks: the serve CLI
    python tests/torch_mesh_ranks.py mixers    # 4 ranks: RG-LRU, SSD, MoE
    python tests/torch_mesh_ranks.py mixers_ckpt DIR  # 2 ranks: recurrent
                                                      # sessions, meshes

Spawns its ranks over a ``FileStore`` in a temporary directory (no socket
but gloo's own on the loopback device); every rank builds the same
seeded weights, a single-device engine and the mesh engine, and checks on
its own.  A failed check in any rank fails the run; rank 0 prints
``RESULT ok`` at the end.  Imports torch and the port only (no JAX), so a
rank starts in a few seconds.
"""

from __future__ import annotations

import dataclasses
import math
import os
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

# each tier's smoke, as the gateway builds it (vocabulary 512); the mesh
# cases at model=2 and model=4: smollm H3/K1 (c); swarm-edge-1b and qwen
# H4/K2 (a) at 2, (b) at 4; llama3-8b H4/K1 (b)
ARCHS = ("smollm-135m", "swarm-edge-1b", "qwen1.5-110b", "llama3-8b")
PROMPTS = np.array([[0, 0, 0, 3, 20, 195, 2],       # left-padded with PAD=0
                    [0, 0, 3, 21, 196, 199, 2],
                    [0, 0, 0, 0, 7, 9, 2],
                    [5, 6, 7, 8, 9, 10, 11]], np.int32)
SPAN = np.array([[11, 12, 2], [13, 2, 0], [14, 15, 16], [17, 2, 0]],
                np.int32)
ATOL = 0.01        # the reference's bf16 logit budget (tie-aware)


def tie_aware(out, ref, what, atol=ATOL, noise=None):
    """``out`` tokens equal ``ref``'s up to the first mismatch, logits
    within ``atol`` before it, and there ``ref``'s top-2 gap within 2 *
    atol (``out["logits"]`` may be absent: tokens only).  A sampled stream
    passes its race's log-noise ``noise`` (B, steps, V) (``race_noise``):
    the gap is then that of the race's scores, logits minus log-noise."""
    lr = np.asarray(ref["logits"].float())
    score = lr if noise is None else lr - noise
    lo = out.get("logits")
    for b in range(ref["tokens"].shape[0]):
        to, tr = np.asarray(out["tokens"][b]), ref["tokens"][b]
        mism = np.where(to != tr[:len(to)])[0]
        n = mism[0] if len(mism) else len(to)
        np.testing.assert_array_equal(to[:n], tr[:n], err_msg=what)
        if lo is not None:
            np.testing.assert_allclose(np.asarray(lo[b, :n].float()),
                                       lr[b, :n], atol=atol, rtol=0,
                                       err_msg=what)
        if len(mism):
            top2 = np.sort(score[b, mism[0]])[-2:]
            assert top2[1] - top2[0] <= 2 * atol, (what, b, top2)


def race_noise(seed: int, B: int, V: int, first: int, n: int):
    """The log-noise of a sampled stream of seed ``seed`` over a batch of B
    (``InferenceEngine._next``: one (B, V) exponential draw per decode
    step, the token the argmax of logits minus log-noise) for its emitted
    tokens ``first`` .. ``first + n - 1``, counted from the stream's start:
    token 0 is the prefill's argmax (no noise) and token t >= 1 came from
    draw t - 1.  Returns (B, n, V)."""
    g = torch.Generator().manual_seed(seed)
    draws = [torch.empty((B, V)).exponential_(1, generator=g).log()
             for _ in range(first + n - 1)]
    zero = torch.zeros((B, V))
    return np.stack([np.asarray(draws[t - 1] if t else zero)
                     for t in range(first, first + n)], axis=1)


def model(arch: str, dtype, seed: int, gain: float = 0.0):
    """``arch``'s smoke at vocabulary 512 from a seed; ``gain`` sets
    ``final_norm`` (an RMSNorm gain of 1 + gain: peaked logits)."""
    from repro_torch import configs as C
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(C.get_smoke(arch), vocab_size=512, dtype=dtype)
    m = T.init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")
    with torch.no_grad():
        m.final_norm.fill_(gain)
    return cfg, m


def check_local_shapes(eng, full, mesh):
    """Each leaf of the rank's shard is the full leaf's slice its spec
    gives, bitwise, but for case (b)'s one KV head and an SSD layer's
    leaves, which are cut by heads segment by segment (``ssd_slice``);
    weights the shard holds quantized are ``check_qtensor_slices``'s."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import ssm
    from repro_torch.models import transformer as T
    axes = T.param_axes(full)
    cfg = eng.cfg
    local = dict(eng.params.named_parameters())
    mods = dict(full.named_modules())
    for name, p in full.named_parameters():
        if name not in local:
            continue                                    # a QTensor now
        mname, _, leaf = name.rpartition(".")
        if isinstance(mods[mname], ssm.SSD):
            want = ssd_slice(cfg, leaf, p, mesh)
        else:
            spec = sh.spec_for(p.shape, axes[name], mesh,
                               sh.SERVE_RULES.param_rules)
            want = p[sh.local_slices(p.shape, spec, mesh)]
            kv_dim = {"wk": 1, "wv": 1, "bk": 0, "bv": 0}.get(leaf)
            if kv_dim is not None \
                    and eng._mcfg.num_kv_heads != cfg.num_kv_heads \
                    and want.shape[kv_dim] == cfg.num_kv_heads:
                want = want.narrow(kv_dim, eng._kv_heads.start, 1)  # (b)
        got = local[name]
        assert got.shape == want.shape, (name, tuple(got.shape),
                                         tuple(want.shape))
        assert torch.equal(got, want), name
    return sum(t.nbytes for t in local.values())


def _model_coord(mesh) -> tuple[int, int]:
    """(this rank's 'model' coordinate, the axis' size)."""
    from repro_torch.distributed import sharding as sh
    return sh.coordinates(mesh)["model"], sh.axis_sizes(mesh)["model"]


def ssd_slice(cfg, leaf: str, p, mesh):
    """An SSD leaf as the rank holds it when its H heads go over 'model'
    (m ranks, m dividing H; whole otherwise), written out segment by
    segment: in_proj's columns [z | x | B | C | dt] -> the rank's z and x
    channels, B and C whole (one group: G = 1 in the smokes), its dt
    heads; the conv's [x | B | C] -> its x channels, B and C whole; A_log,
    dt_bias, D_skip by heads, gnorm and out_proj's rows by channels."""
    r, m = _model_coord(mesh)
    H, P, N = cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state
    if H % m or leaf == "norm":
        return p
    assert cfg.ssm_ngroups == 1, cfg.ssm_ngroups
    hl, di = H // m, cfg.ssm_d_inner
    dl = hl * P
    if leaf in ("A_log", "dt_bias", "D_skip"):
        return p[r * hl:(r + 1) * hl]
    if leaf in ("gnorm", "out_proj"):
        return p[r * dl:(r + 1) * dl]
    if leaf == "in_proj":
        return torch.cat([p[:, r * dl:(r + 1) * dl],
                          p[:, di + r * dl:di + (r + 1) * dl],
                          p[:, 2 * di:2 * di + 2 * N],
                          p[:, 2 * di + 2 * N + r * hl:
                            2 * di + 2 * N + (r + 1) * hl]], 1)
    x = p[..., r * dl:(r + 1) * dl]                       # conv_w, conv_b
    return torch.cat([x, p[..., di:]], -1)


def state_width(cfg, kind, mesh) -> dict:
    """The rank's state shapes past the batch dim of a recurrent layer
    (``kind``: an ``RGLRUState`` or ``SSMState`` class): the RG-LRU's W/m
    (W where m does not divide it), an SSD's H/m heads and d_inner/m + 2N
    conv channels (whole where m does not divide H)."""
    from repro_torch.models import rglru
    _, m = _model_coord(mesh)
    if kind is rglru.RGLRUState:
        W = cfg.rnn_width or cfg.d_model
        w = W // m if W % m == 0 else W
        return {"h": (w,), "conv": (cfg.rnn_conv_width - 1, w)}
    H, P, N = cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state
    h = H // m if H % m == 0 else H
    return {"ssd": (h, P, N),
            "conv": (cfg.ssm_conv_width - 1, h * P + 2 * N)}


def check_state_shapes(cfg, cache, mesh):
    """Every recurrent entry of a cache list (or pool) holds the rank's
    width or heads (``state_width``)."""
    from repro_torch.models import transformer as T
    for c in cache:
        if isinstance(c, T.STATE_TYPES):
            for f, shape in state_width(cfg, type(c), mesh).items():
                got = tuple(getattr(c, f).shape[1:])
                assert got == shape, (type(c).__name__, f, got, shape)


def engines_case(mesh, arch: str, seed: int, kw=None,
                 dtypes=(torch.bfloat16, torch.float32), build=None):
    """``arch``'s engine on ``mesh`` (built with ``kw``) against one
    device's (the same ``kw``) through every entry point, tie-aware; the
    model from ``build`` (default ``model``)."""
    from repro_torch.core.uncertainty import UncertaintyConfig
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.scheduler import Request
    ucfg = UncertaintyConfig(mode="distribution")
    kw = kw or {}
    for dtype in dtypes:
        cfg, m = (build or model)(arch, dtype, seed)
        base = InferenceEngine(arch, cfg, m, ucfg, device="cpu", **kw)
        shard = InferenceEngine(arch, cfg, m, ucfg, device="cpu", mesh=mesh,
                                **kw)
        if kw.get("weight_quant"):
            check_qtensor_slices(shard, m, kw["weight_quant"], mesh)
        check_local_shapes(shard, m, mesh)
        if kw.get("paged"):
            check_pool_shapes(shard, mesh)
        tag = (f"{arch} {dtype} {kw} "
               f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}")
        r0 = base.generate(PROMPTS, 8, return_state=True)
        r1 = shard.generate(PROMPTS, 8, return_state=True)
        if not kw.get("paged"):
            check_state_shapes(cfg, r1["state"].cache, mesh)
        tie_aware(r1, r0, tag + " generate")
        if dtype == torch.float32:
            np.testing.assert_allclose(r1["u"], r0["u"], atol=1e-4,
                                       rtol=0, err_msg=tag)
        # decode-only extension, then rows of it (state_select)
        e0 = base.generate(None, 6, state=r0["state"], return_state=True)
        e1 = shard.generate(None, 6, state=r1["state"], return_state=True)
        tie_aware(e1, e0, tag + " extension")
        # rows whose streams agree so far (a flipped row continues another
        # history), one of them repeated
        same = [b for b in range(4)
                if np.array_equal(r1["tokens"][b], r0["tokens"][b])
                and np.array_equal(e1["tokens"][b], e0["tokens"][b])]
        assert len(same) >= 2, (tag, same)
        pick = [same[-1], same[0], same[0]]
        s0 = base.generate(None, 4, state=base.state_select(
            e0["state"], pick))
        s1 = shard.generate(None, 4, state=shard.state_select(
            e1["state"], pick))
        tie_aware(s1, s0, tag + " state_select")
        # two rows: split over 'data' where it divides 2 (a row may change
        # data rank), else replicated
        s0 = base.generate(None, 3, state=base.state_select(
            e0["state"], pick[:2]))
        s1 = shard.generate(None, 3, state=shard.state_select(
            e1["state"], pick[:2]))
        tie_aware(s1, s0, tag + " state_select of 2")
        if kw.get("paged") and shard._dshards > 1:
            # the 3 picked rows are replicated, the source was split: the
            # rows other data ranks held moved over
            assert shard.counters["rows_moved"] > 0, shard.counters
        # absorb, then a warm continuation
        w0 = base.generate(SPAN, 6, state=base.absorb(PROMPTS))
        w1 = shard.generate(SPAN, 6, state=shard.absorb(PROMPTS))
        tie_aware(w1, w0, tag + " warm continuation")
        # serve(): 2 slots (replicated over data=4) and 4 (one each)
        for n_slots in (2, 4):
            fin = shard.serve([Request(rid=i, prompt=PROMPTS[i].tolist(),
                                       max_new=8, return_state=(i == 1))
                               for i in range(4)], n_slots=n_slots,
                              decode_chunk=3)
            got = {r["rid"]: r for r in fin}
            tie_aware({"tokens": [got[i]["tokens"] for i in range(4)]}, r0,
                      f"{tag} serve n_slots={n_slots}")
            ref1 = base.generate(PROMPTS[1:2], 8, return_state=True)
            if np.array_equal(got[1]["tokens"], ref1["tokens"][0]):
                x1 = shard.generate(None, 4, state=got[1]["state"])
                x0 = base.generate(None, 4, state=ref1["state"])
                tie_aware(x1, x0, f"{tag} serve n_slots={n_slots} "
                                  "returned state")
        if dtype == torch.float32:
            sampled_case(base, shard, tag, seed=3 + seed)
        assert shard.counters["mesh_eager"] > 0, shard.counters
        if kw.get("paged"):
            fan_case(base, shard, tag)


def sampled_case(base, shard, tag: str, seed: int):
    """A sampled stream (``greedy=False``) is the one the same seed gives
    on one device, on any split of the batch: a cold ``generate``, its
    decode-only extension (the carried generator) and ``serve()`` over 4
    slots, tie-aware in the race's scores."""
    from repro_torch.serving.scheduler import Request
    B, V = PROMPTS.shape[0], shard.cfg.vocab_size
    r0 = base.generate(PROMPTS, 8, greedy=False, seed=seed,
                       return_state=True)
    r1 = shard.generate(PROMPTS, 8, greedy=False, seed=seed,
                        return_state=True)
    greedy = base.generate(PROMPTS, 8)["tokens"]
    assert not np.array_equal(r0["tokens"], greedy), tag    # it samples
    tie_aware(r1, r0, tag + " sampled generate",
              noise=race_noise(seed, B, V, 0, 8))
    e0 = base.generate(None, 6, state=r0["state"], greedy=False)
    e1 = shard.generate(None, 6, state=r1["state"], greedy=False)
    if np.array_equal(r1["tokens"], r0["tokens"]):
        tie_aware(e1, e0, tag + " sampled extension",
                  noise=race_noise(seed, B, V, 8, 6))
    reqs = [Request(rid=i, prompt=PROMPTS[i].tolist(), max_new=8)
            for i in range(B)]
    f0 = base.serve(reqs, n_slots=4, decode_chunk=3, greedy=False,
                    seed=seed)
    reqs = [Request(rid=i, prompt=PROMPTS[i].tolist(), max_new=8)
            for i in range(B)]
    f1 = shard.serve(reqs, n_slots=4, decode_chunk=3, greedy=False,
                     seed=seed)
    got = {r["rid"]: r["tokens"] for r in f1}
    for r in f0:
        np.testing.assert_array_equal(got[r["rid"]], r["tokens"],
                                      err_msg=tag + " sampled serve")


def check_qtensor_slices(eng, full, quant: str, mesh):
    """Each of the rank's ``QTensor`` weights is bitwise the slice of the
    whole model's ``quantize_params`` tree its spec gives (case (b):
    wk/wv's one KV head), payload and scales; and the payload shapes are
    the full ones divided so."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import quant as Q
    from repro_torch.models import transformer as T
    fq = Q.quantize_params(full, quant)
    axes = Q.quantize_param_axes(T.param_axes(fq), fq)
    local = dict(eng.params.named_modules())
    kv0, kl = eng._kv_heads.start, eng._kv_heads.count
    names = Q.quantized_names(fq)
    assert names and names == Q.quantized_names(eng.params), names
    for name, q in ((n, m) for n, m in fq.named_modules()
                    if isinstance(m, Q.QTensor)):
        for leaf in ("q", "scale"):
            t = getattr(q, leaf)
            spec = sh.spec_for(t.shape, axes[f"{name}.{leaf}"], mesh,
                               sh.SERVE_RULES.param_rules)
            want = t[sh.local_slices(t.shape, spec, mesh)]
            if (name.endswith(("wk", "wv")) and kl < full.cfg.num_kv_heads
                    and want.shape[1] == full.cfg.num_kv_heads):
                want = want[:, kv0:kv0 + kl]                     # case (b)
            got = getattr(local[name], leaf)
            assert got.dtype == want.dtype, (name, leaf)
            assert torch.equal(got.view(torch.uint8) if got.dtype ==
                               torch.float8_e4m3fn else got,
                               want.view(torch.uint8) if want.dtype ==
                               torch.float8_e4m3fn else want), (name, leaf)


def check_pool_shapes(eng, mesh):
    """Each leaf of the rank's pool (its served blocks) is the full pool's
    with the blocks cut to the rank's share (``sharding.pool_share``:
    ``n / d`` over the batch axes) and the KV heads those the rank's
    attention holds (``_mcfg``; case (b): one); and the shares are the
    full counts over the batch axes' size."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import transformer as T
    cfg, pool = eng.cfg, eng.pool
    n_blocks = eng.pool_blocks
    d = math.prod(sh.axis_sizes(mesh)[a] for a in sh.batch_axes(mesh))
    assert pool.n_blocks == sh.pool_share(n_blocks, mesh) == n_blocks // d, \
        (pool.n_blocks, n_blocks, d)
    assert pool.n_rows == sh.pool_share(eng.pool_rows, mesh) \
        == eng.pool_rows // d, (pool.n_rows, eng.pool_rows)
    full = T.init_block_pool(cfg, n_blocks, eng.block_len, 1,
                             cache_quant=eng.cache_quant, device="meta")
    check_state_shapes(cfg, pool.arrays, mesh)
    for fl, ll in zip(full, pool.arrays):
        if isinstance(fl, T.STATE_TYPES):
            assert all(t.shape[0] == pool.n_rows + 1 for t in ll)
            continue
        for f, t in zip(fl.served(), ll.served()):
            if f is None:
                assert t is None
                continue
            want = [n_blocks // d, *f.shape[1:]]
            if len(want) > 2:
                want[2] = eng._mcfg.num_kv_heads
            assert list(t.shape) == want, (list(t.shape), want)
            assert t.dtype == f.dtype, (t.dtype, f.dtype)


def fan_case(base, shard, tag: str):
    """A batch-1 session fanned out to 4 rows on a paged engine, each
    continued (the rows of a split fan-out move to the other data ranks);
    then both released: every block and row they took returns."""
    before = (shard.pool.blocks_in_use, shard.pool.rows_in_use)
    r0 = base.generate(PROMPTS[1:2], 4, return_state=True)
    r1 = shard.generate(PROMPTS[1:2], 4, return_state=True)
    tie_aware(r1, r0, tag + " fanout source")
    if not np.array_equal(r1["tokens"], r0["tokens"]):
        return
    f0 = base.generate(None, 4, state=base.fanout(r0["state"], 4))
    f1 = shard.generate(None, 4, state=shard.fanout(r1["state"], 4),
                        return_state=True)
    tie_aware(f1, f0, tag + " fanout")
    shard.release(f1["state"])
    shard.release(r1["state"])
    after = (shard.pool.blocks_in_use, shard.pool.rows_in_use)
    assert after == before, (tag, before, after)


#: the paged and quantized layouts of the ``paged`` job, one per (mesh,
#: arch) in turn: each mesh serves four of them, each layout two meshes
PAGED = dict(paged=True, block_len=8, pool_blocks=512, pool_rows=64)
LAYOUTS = (dict(PAGED),
           dict(PAGED, attn_decode_impl="gather"),
           dict(PAGED, cache_quant="int8"),
           dict(PAGED, cache_quant="fp8", weight_quant="int8"),
           dict(weight_quant="fp8"),
           dict(PAGED, weight_quant="fp8", attn_decode_impl="gather"))


def run_paged(rank: int, world: int, arg=None):
    """Each (data, model) mesh over the layouts in turn (bf16; f32 as well
    for two paged layouts on (2, 2) and one on (4, 1): ``sampled_case``
    on a split paged batch), then a (pod, data, model) mesh, where a batch
    of 4 splits over pod * data and one of 2 (serve's 2 slots, a 2-row
    selection) over 'data' alone, each row on its two pod replicas."""
    from repro_torch.launch.mesh import elastic_mesh, serving_mesh
    for j, mp_ in enumerate((2, 4, 1)):
        mesh = serving_mesh(model_parallel=mp_)
        for i, arch in enumerate(ARCHS):
            kw = LAYOUTS[(i + 2 * j) % len(LAYOUTS)]
            f32 = mp_ != 4 and kw.get("paged") and i % 2 == 0
            engines_case(mesh, arch, seed=i, kw=kw,
                         dtypes=(torch.bfloat16,) + ((torch.float32,)
                                                     if f32 else ()))
        if rank == 0:
            print(f"paged mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}"
                  " ok", flush=True)
    mesh = elastic_mesh(model_parallel=1, pods=2)
    assert tuple(mesh.shape) == (2, 2, 1), mesh
    engines_case(mesh, "llama3-8b", seed=5, kw=LAYOUTS[2],
                 dtypes=(torch.bfloat16,))
    if rank == 0:
        print(f"paged mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} ok",
              flush=True)


def _raises(fn, exc) -> bool:
    try:
        fn()
    except exc:
        return True
    return False


def _same_everywhere(x) -> list:
    """Every rank's ``x`` (a list of ints), gathered."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, list(x))
    return out


def run_lockstep(rank: int, world: int, arg=None):
    """Two data ranks, (2, 1): pool decisions that differ between the
    ranks' pools are taken together.  Each step runs under the job's
    subprocess timeout: a rank that raised alone would hang the other."""
    from repro_torch.core.uncertainty import UncertaintyConfig
    from repro_torch.launch.mesh import serving_mesh
    from repro_torch.serving.cache_manager import EvictedSessionError
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.faults import PoolExhaustedError
    from repro_torch.serving.scheduler import Request
    mesh = serving_mesh(model_parallel=1)
    assert tuple(mesh.shape) == (2, 1), mesh
    cfg, m = model("llama3-8b", torch.float32, 3)
    ucfg = UncertaintyConfig(mode="distribution")
    kw = dict(paged=True, block_len=8, pool_blocks=64, pool_rows=16)
    eng = InferenceEngine("l", cfg, m, ucfg, device="cpu", mesh=mesh, **kw)
    base = InferenceEngine("b", cfg, m, ucfg, device="cpu", **kw)
    nb = 128 // 8                       # blocks per row and per serve slot
    assert eng.pool.n_blocks == 32
    # (1) rows of unequal provenance: a split session (one row per rank)
    # forked so that both rows of the fork read row 0 — rank 1's copy moves
    # over and takes fresh blocks there, rank 0's shares its table
    r = eng.generate(PROMPTS[:2], 4, return_state=True)
    fork = eng.state_select(r["state"], [0, 0])
    assert eng.counters["rows_moved"] == 1, eng.counters
    used = _same_everywhere([eng.pool.blocks_in_use])
    assert used[1][0] > used[0][0], used               # rank 1 holds more
    x = eng.generate(None, 3, state=fork)
    b0 = base.generate(PROMPTS[:2], 4, return_state=True)
    tie_aware(x, base.generate(None, 3, state=base.state_select(
        b0["state"], [0, 0])), "lockstep fork")
    # a fresh B=2 generate needs nb blocks on each rank: squeezed so that
    # rank 0 has exactly nb and rank 1 one fewer, both raise and neither
    # allocates
    used = _same_everywhere([eng.pool.blocks_in_use])
    pad = eng.pool.alloc_blocks(32 - used[0][0] - nb)
    held = eng.pool.blocks_in_use
    assert _raises(lambda: eng.generate(PROMPTS[:2], 4), PoolExhaustedError)
    assert eng.pool.blocks_in_use == held
    eng.pool.free_blocks(pad)
    eng.release(r["state"])
    eng.release(fork)
    assert eng.pool.blocks_in_use == 0, eng.pool.blocks_in_use
    # (2) serve(): rank 0 can fund one slot's run, rank 1 two; over 4
    # slots (two per rank) the batcher fills slot 0 and stops at slot 1
    # (rank 0's), so the queue waits on both ranks, and every request
    # finishes with one device's tokens
    hold = eng.pool.alloc_blocks(32 - nb - 4 if rank == 0 else 0)
    new = [3 + 2 * i for i in range(4)]
    fin = {f["rid"]: f["tokens"] for f in eng.serve(
        [Request(rid=i, prompt=PROMPTS[i].tolist(), max_new=new[i])
         for i in range(4)], n_slots=4, decode_chunk=2)}
    for i in range(4):
        tie_aware({"tokens": [fin[i]]},
                  base.generate(PROMPTS[i:i + 1], new[i]), f"serve {i}")
    assert eng.counters["backpressure_deferred"] > 0, eng.counters
    c = _same_everywhere([eng.counters[k] for k in sorted(eng.counters)])
    assert c[0] == c[1], c
    # rank 0 cannot fund any slot now: nothing is admitted, nothing
    # decodes, and both ranks raise (or shed every request, together)
    more = eng.pool.alloc_blocks(5 if rank == 0 else 0)
    assert _raises(lambda: eng.serve(
        [Request(rid=0, prompt=PROMPTS[0].tolist(), max_new=2)],
        n_slots=2), PoolExhaustedError)
    shed = eng.serve([Request(rid=i, prompt=PROMPTS[i].tolist(), max_new=2)
                      for i in range(2)], n_slots=2, overload="shed")
    assert [f.get("shed") for f in shed] == [True, True], shed
    eng.pool.free_blocks(np.concatenate([hold, more]))
    assert eng.pool.blocks_in_use == 0, eng.pool.blocks_in_use
    # (3) TTL eviction under clocks that disagree: rank 0's runs ahead, so
    # only it finds the session idle; both evict it
    st = eng.absorb(PROMPTS[:1])
    clock = [0.0]
    eng.pool._clock = lambda: clock[0]
    eng.pool.check(st.cache)                           # touch at t = 0
    clock[0] = 10.0 if rank == 0 else 0.5
    assert eng.evict_idle_sessions(1.0) == 1
    assert _raises(lambda: eng.generate(None, 2, state=st),
                   EvictedSessionError)
    assert eng.pool.blocks_in_use == 0 and eng.pool.rows_in_use == 0
    if rank == 0:
        print("lockstep ok", flush=True)


def run_cli(rank: int, world: int, arg=None):
    """``python -m repro_torch.launch.serve --device cpu --model-parallel 2
    --paged --cache-quant int8`` on the two ranks (``main`` joins their
    group), then, on rank 0, the same command on one device: the same
    routing decisions (both train the same weights: one thread a rank)."""
    from repro_torch.launch import serve
    args = ["--device", "cpu", "--train-steps", str(arg or 40), "--paged",
            "--cache-quant", "int8"]
    log, _, _ = serve.main(args + ["--model-parallel", "2"])
    if rank == 0:
        one, _, _ = serve.main(args)
        np.testing.assert_array_equal(log.decision, one.decision)
        np.testing.assert_array_equal(log.answers, one.answers)
        print(f"cli routes {np.bincount(log.decision).tolist()} ok",
              flush=True)


CKPT_ARCH, CKPT_SEED = "llama3-8b", 7
CKPT_POOL = dict(paged=True, block_len=8, pool_blocks=256, pool_rows=32)


def ckpt_reference(arch: str = None):
    """(model config, weights, the single-device paged engine's first
    generate with its session, and that session's uninterrupted 5-token
    continuation): what every restored session is held to."""
    from repro_torch.core.uncertainty import UncertaintyConfig
    from repro_torch.serving.engine import InferenceEngine
    cfg, m = model(arch or CKPT_ARCH, torch.float32, CKPT_SEED)
    one = InferenceEngine("one", cfg, m, UncertaintyConfig(
        mode="distribution"), device="cpu", **CKPT_POOL)
    r = one.generate(PROMPTS, 6, return_state=True)
    return cfg, m, r, one.generate(None, 5, state=r["state"])


def run_ckpt(rank: int, world: int, arg: str):
    """Sessions across layouts (``llama3-8b`` H4/K1: case (b) on (2, 2),
    its one KV head repeated over 'model' and saved once): saved on (2, 2)
    paged, restored on (2, 2) paged (bitwise the uninterrupted (2, 2) run),
    on (4, 1) monolithic and on one device, monolithic and paged; saved on
    one device (rank 0 writes) and on (4, 1) monolithic, restored on
    (2, 2) paged; then ``swarm-edge-1b`` (H4/K2) saved on (1, 4), where
    ranks 0-1 hold KV head 0 and ranks 2-3 head 1 (case (b)), restored on
    (2, 2) (case (a)) and on one device.  Each restored continuation is
    held to the uninterrupted one of the same session.  ``arg``: the
    directory; ``<arg>/mesh22`` and the (2, 2) run's continuation
    ``<arg>/c22.npz`` stay for the caller's in-process restores."""
    from repro_torch.core.uncertainty import UncertaintyConfig
    from repro_torch.launch.mesh import serving_mesh
    from repro_torch.serving.engine import InferenceEngine
    cfg, m, r0, c0 = ckpt_reference()
    ucfg = UncertaintyConfig(mode="distribution")

    def eng(mesh=None, **kw):
        return InferenceEngine("e", cfg, m, ucfg, device="cpu", mesh=mesh,
                               **kw)
    m22, m41 = serving_mesh(model_parallel=2), serving_mesh(model_parallel=1)
    d22, d_one, d41 = (os.path.join(arg, n) for n in ("mesh22", "one",
                                                      "mesh41"))
    e22 = eng(m22, **CKPT_POOL)
    r = e22.generate(PROMPTS, 6, return_state=True)
    tie_aware(r, r0, "ckpt (2,2) generate")
    path = e22.checkpoint_session(r["state"], d22)
    assert os.path.isdir(path), path
    c22 = e22.generate(None, 5, state=r["state"])
    tie_aware(c22, c0, "ckpt (2,2) uninterrupted")
    if rank == 0:
        np.savez(os.path.join(arg, "c22.npz"), tokens=c22["tokens"],
                 logits=c22["logits"].numpy())
    f22 = eng(m22, **CKPT_POOL)
    x = f22.generate(None, 5, state=f22.restore_session(d22))
    np.testing.assert_array_equal(x["tokens"], c22["tokens"])
    assert torch.equal(x["logits"], c22["logits"]), "(2,2) -> (2,2)"
    # held to the uninterrupted continuation of the same session
    for what, e in (("(4,1) monolithic", eng(m41)),
                    ("one device monolithic", eng()),
                    ("one device paged", eng(**CKPT_POOL))):
        x = e.generate(None, 5, state=e.restore_session(d22))
        tie_aware(x, c22, f"ckpt (2,2) paged -> {what}")
    if rank == 0:
        one = eng(**CKPT_POOL)
        one.checkpoint_session(one.generate(PROMPTS, 6, return_state=True)
                               ["state"], d_one)
    dist.barrier()
    e41 = eng(m41)
    s41 = e41.generate(PROMPTS, 6, return_state=True)["state"]
    e41.checkpoint_session(s41, d41)
    c41 = e41.generate(None, 5, state=s41)
    for what, d, c in (("one device", d_one, c0),
                       ("(4,1) monolithic", d41, c41)):
        e = eng(m22, **CKPT_POOL)
        x = e.generate(None, 5, state=e.restore_session(d))
        tie_aware(x, c, f"ckpt {what} -> (2,2) paged")
    cfg, m, r0, c0 = ckpt_reference("swarm-edge-1b")
    e14 = eng(serving_mesh(model_parallel=4), **CKPT_POOL)
    assert (e14._kv_heads.start, e14._kv_heads.count) == (rank // 2, 1), \
        e14._kv_heads
    r = e14.generate(PROMPTS, 6, return_state=True)
    tie_aware(r, r0, "ckpt (1,4) generate")
    d14 = os.path.join(arg, "mesh14")
    e14.checkpoint_session(r["state"], d14)
    c14 = e14.generate(None, 5, state=r["state"])
    tie_aware(c14, c0, "ckpt (1,4) uninterrupted")
    for what, e in (("(2,2) paged", eng(m22, **CKPT_POOL)),
                    ("one device", eng())):
        x = e.generate(None, 5, state=e.restore_session(d14))
        tie_aware(x, c14, f"ckpt (1,4) paged -> {what}")
    if rank == 0:
        print("ckpt ok", flush=True)


def run_engines(rank: int, world: int, arg=None):
    from repro_torch.launch.mesh import data_shards, serving_mesh
    for mp_ in (2, 4, 1):
        mesh = serving_mesh(model_parallel=mp_)
        assert data_shards(mesh) * mp_ == world, mesh
        for i, arch in enumerate(ARCHS):
            engines_case(mesh, arch, seed=i)
        if rank == 0:
            print(f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} ok",
                  flush=True)
    refusals(serving_mesh(model_parallel=2))
    if rank == 0:
        print("refusals ok", flush=True)


def refusals(mesh):
    """On the (2, 2) mesh: heads that neither split with their KV heads nor
    share one per rank (H6/K3 over model=2) need the sequence-sharded
    cache; a graph handed to an engine of more than one rank is not
    captured.  Each raises NotImplementedError naming what is missing.
    The FSDP rules (DEFAULT_RULES cut d_model over 'data'), once refused
    here, cut the training shard: its leaves are the spec slices of the
    whole (``fsdp_slices``)."""
    from repro_torch import configs as C
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving import graphs
    odd = dataclasses.replace(C.get_smoke("swarm-edge-1b"), num_heads=6,
                              num_kv_heads=3)
    llama = C.get_smoke("llama3-8b")

    def captured():
        eng = InferenceEngine("x", llama, T.Transformer(llama), device="cpu",
                              mesh=mesh, paged=True)
        eng._graphs = graphs.DecodeGraphs(graphs.Rerun())
        eng.generate(PROMPTS, 2)
    for build, what in (
            (captured, "graph capture over more than one rank"),
            (lambda: InferenceEngine("x", odd, T.Transformer(odd),
                                     device="cpu", mesh=mesh),
             "sequence-sharded")):
        try:
            build()
        except NotImplementedError as e:
            assert what in str(e), (what, str(e))
        else:
            raise AssertionError(f"no refusal: {what}")
    fsdp_slices(mesh)


def run_gateway(rank: int, world: int, arg=None, engine_kw=None,
                label: str = "gateway"):
    """The four f32 tiers and the classifier through ``gateway_from_weights``
    with fixed thresholds (no calibration), single device and on the (1, 2)
    mesh, every tier built with ``engine_kw``: the same decisions, answers
    and emitted tokens."""
    from repro_torch.core import safety as S
    from repro_torch.core.router import RouterConfig
    from repro_torch.data.workload import FactWorld
    from repro_torch.launch.mesh import serving_mesh
    from repro_torch.launch.serve import gateway_from_weights
    from repro_torch.serving.swarm import pad_prompts
    mesh = serving_mesh(model_parallel=2)
    assert tuple(mesh.shape) == (1, 2), mesh
    tiers = {k: model(a, torch.float32, i, 5.0) for i, (k, a) in enumerate(zip(
        ("probe", "edge_1b", "edge_qwen", "cloud"), ARCHS))}
    scfg = dataclasses.replace(S.classifier_config(vocab_size=512),
                               dtype=torch.float32)
    sp = S.init_safety(scfg, torch.Generator().manual_seed(5),
                       device="cpu")
    with torch.no_grad():
        sp.embed.mul_(30.0)             # s spread over the workload
    world_ = FactWorld(n_ent=16, n_rel=6)
    queries = world_.study_workload()
    logs, toks = [], []
    for m in (None, mesh):
        gw, probe, _, _ = gateway_from_weights(
            **tiers, safety=(scfg, sp), device="cpu", world=world_,
            calibrate=False, mesh=m, engine_kw=engine_kw,
            router_cfg=RouterConfig(tau_low=0.0, tau_high=1.0, sigma=0.5))
        if m is None:
            # thresholds in the widest gaps of the probe's u and the s
            u = probe.generate(pad_prompts([q["prompt"] for q in queries]),
                               8)["u"]
            us = np.sort(u)
            g = np.diff(us)
            lo = 10 + int(np.argmax(g[10:30]))
            hi = 32 + int(np.argmax(g[32:47]))
            rcfg = RouterConfig(tau_low=float(us[lo:lo + 2].mean()),
                                tau_high=float(us[hi:hi + 2].mean()),
                                sigma=0.7, peers_k=2, gamma=0.3, l_max=4.0)
        gw.router_cfg = rcfg
        logs.append(gw.answer_batch(queries))
        toks.append(probe.generate(pad_prompts(
            [q["prompt"] for q in queries]), 8)["tokens"])
    a, b = logs
    np.testing.assert_array_equal(b.decision, a.decision)
    np.testing.assert_array_equal(b.answers, a.answers)
    np.testing.assert_array_equal(toks[1], toks[0])
    np.testing.assert_allclose(b.u, a.u, atol=1e-4, rtol=0)
    assert len(set(a.decision.tolist())) >= 2, a.decision
    if rank == 0:
        print(f"{label} decisions {np.bincount(a.decision).tolist()} ok",
              flush=True)


def run_paged_gateway(rank: int, world: int, arg=None):
    """``run_gateway`` with every tier on an int8 block pool, as
    ``launch.serve --paged --cache-quant int8`` builds them."""
    run_gateway(rank, world, engine_kw=dict(paged=True, pool_blocks=256,
                                            cache_quant="int8"),
                label="paged gateway")


#: the recurrent and MoE decoders: on (1, 4), (2, 2) and (4, 1) the
#: recurrentgemma smoke (W 64, H4/K1: attention (b) at model 2 and 4), the
#: mamba2 smoke (8 SSD heads, G=1), deepseek (8 experts top-2, 2 shared,
#: H4/K4: (a)) and llama4-scout (4 experts top-1, 1 shared, H4/K2: (a) at
#: 2, (b) at 4)
MIXERS = ("recurrentgemma-2b", "mamba2-780m", "deepseek-moe-16b",
          "llama4-scout-17b-a16e")
RECURRENT = ("recurrentgemma-2b", "mamba2-780m")
#: each mesh's layout per decoder (in ``MIXERS`` order): every decoder
#: monolithic and paged, each quantized layout twice; deepseek paged with
#: int8 weights on (2, 2); the mamba2 smoke has no weight to quantize
MIX_PLAN = {
    4: ({}, dict(PAGED), dict(PAGED, cache_quant="int8"),
        dict(weight_quant="int8")),
    2: (dict(PAGED, cache_quant="int8"), {},
        dict(PAGED, weight_quant="int8"),
        dict(PAGED, weight_quant="fp8", attn_decode_impl="gather")),
    1: (dict(PAGED, weight_quant="fp8"),
        dict(PAGED, attn_decode_impl="gather"), {}, dict(PAGED))}


def mixer_model(arch: str, dtype, seed: int, gain: float = 0.0):
    """``model``, with every matrix of a recurrent smoke but the embedding
    and the convs scaled by 6: at the init scale the tied smoke's greedy
    streams repeat their last prompt token (as the recurrent engine tests
    scale them)."""
    cfg, m = model(arch, dtype, seed, gain)
    if arch in RECURRENT:
        with torch.no_grad():
            for name, p in m.named_parameters():
                if p.dim() >= 2 and "embed" not in name \
                        and "conv" not in name:
                    p.mul_(6.0)
    return cfg, m


def gather_model(arch: str, dtype, seed: int):
    """``mixer_model`` with ``moe_decode_impl="gather"``: decode multiplies
    the k selected experts' rows only."""
    cfg, m = mixer_model(arch, dtype, seed)
    return dataclasses.replace(cfg, moe_decode_impl="gather"), m


def moe_combine_case(mesh, arch: str, seed: int):
    """MoE's combine over 'model' is bitwise one device's: given the same
    routing (the single device's ranks and slots), the rank's experts'
    rows joined by the all-reduce (``moe._routed``) equal the single
    device's rows, and so does the gather decode's join; then the gate
    weighting is the same arithmetic on the same numbers."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    cfg, m = mixer_model(arch, torch.float32, seed)
    shard = T.shard_params(m, cfg, mesh)
    i = next(j for j, (_, f) in enumerate(cfg.layer_plan()) if f == "moe")
    full, mine = m.layers[i].ffn, shard.layers[i].ffn
    _, n = _model_coord(mesh)
    assert mine.w_gate.shape[0] == cfg.num_experts // n
    g = torch.Generator().manual_seed(seed)
    S, B, D = 5, 4, cfg.d_model
    hf = torch.randn((S, B, D), generator=g)
    valid = torch.rand((S, B), generator=g) > 0.2
    _, idx, _ = moe._route_topk(full.router, hf, cfg, valid=valid)
    A, C = B * cfg.top_k, moe.moe_serve_capacity(cfg, B)
    va = valid[..., None].expand(S, B, cfg.top_k).reshape(S, A)
    flat_e = torch.where(va, idx.reshape(S, A), cfg.num_experts)
    pos = moe._rank_in_expert(flat_e)
    keep = (pos < C) & va
    y0 = moe._routed(full, hf, flat_e, pos, keep, C, cfg)
    y1 = moe._routed(mine, hf, flat_e, pos, keep, C, cfg)
    assert torch.equal(y1, y0), f"{arch}: the expert-parallel rows differ"
    gates = torch.rand((S, B, cfg.top_k), generator=g)
    w = (gates.reshape(S, A) * keep).float()[..., None]
    assert torch.equal((y1.float() * w).reshape(S, B, cfg.top_k, D).sum(2),
                       (y0.float() * w).reshape(S, B, cfg.top_k, D).sum(2))
    # the decode gather's join: every assignment is some rank's
    tid = idx[0]
    own, loc = moe._owned(mine, tid)
    rows = mine.w_down[loc].sum(-2)                           # (B, k, D)
    got = moe._join(mine, rows, own)
    assert torch.equal(got, full.w_down[tid].sum(-2)), arch
    return sh.axis_sizes(mesh)


def run_mixers(rank: int, world: int, arg=None):
    """Each (data, model) mesh over the four decoders, a layout each
    (``MIX_PLAN``):
    the rank's leaves the placements' slices (``check_local_shapes``,
    ``check_qtensor_slices``), its states and pool rows its width or
    heads, every entry point tie-aware one device's (f32 copies of the
    recurrent smokes: their scaled weights make bf16 noise read past the
    budget), llama4-scout's gather decode on (1, 4); then MoE's combine
    bitwise one device's."""
    from repro_torch.launch.mesh import serving_mesh
    for mp_, plan in MIX_PLAN.items():
        mesh = serving_mesh(model_parallel=mp_)
        for i, (arch, kw) in enumerate(zip(MIXERS, plan)):
            dtype = torch.float32 if arch in RECURRENT else torch.bfloat16
            engines_case(mesh, arch, seed=i, kw=kw, dtypes=(dtype,),
                         build=mixer_model)
        if mp_ == 4:
            # the MoE gather decode: the rank's experts' rows, joined
            engines_case(mesh, "llama4-scout-17b-a16e", seed=4, kw=PAGED,
                         dtypes=(torch.bfloat16,), build=gather_model)
        for arch in MIXERS[2:]:
            moe_combine_case(mesh, arch, seed=3)
        if rank == 0:
            print(f"mixers mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}"
                  " ok", flush=True)
    if rank == 0:
        print("moe combine bitwise ok", flush=True)


MIX_CKPT = dict(paged=True, block_len=8, pool_blocks=128, pool_rows=16)


def mixer_ckpt_reference(arch: str):
    """(config, weights, the single-device paged engine's first generate
    with its session, and that session's uninterrupted 5-token
    continuation) of a recurrent smoke in f32."""
    from repro_torch.core.uncertainty import UncertaintyConfig
    from repro_torch.serving.engine import InferenceEngine
    cfg, m = mixer_model(arch, torch.float32, CKPT_SEED)
    one = InferenceEngine("one", cfg, m, UncertaintyConfig(
        mode="distribution"), device="cpu", **MIX_CKPT)
    r = one.generate(PROMPTS, 6, return_state=True)
    return cfg, m, r, one.generate(None, 5, state=r["state"])


def run_mixers_ckpt(rank: int, world: int, arg: str):
    """Recurrent sessions across layouts, for the recurrentgemma smoke
    (RG-LRU width and attention (b)) and the mamba2 smoke (SSD heads): saved
    on (1, 2) paged (each rank half the width or heads; the SSD conv tail's
    B/C columns held by both and saved once), restored on (1, 2) paged
    (bitwise the uninterrupted (1, 2) run), on one device (monolithic and
    paged) and on (2, 1) monolithic, each held to the uninterrupted
    continuation of the same session tie-aware; saved on (2, 1)
    monolithic, restored on (1, 2) paged.  ``arg``: the directory;
    ``<arg>/<arch>12`` and the (1, 2) run's continuation
    ``<arg>/<arch>12.npz`` stay for the caller's in-process restores."""
    from repro_torch.core.uncertainty import UncertaintyConfig
    from repro_torch.launch.mesh import serving_mesh
    from repro_torch.serving.engine import InferenceEngine
    ucfg = UncertaintyConfig(mode="distribution")
    m12, m21 = serving_mesh(model_parallel=2), serving_mesh(model_parallel=1)
    assert tuple(m12.shape) == (1, 2) and tuple(m21.shape) == (2, 1)
    for arch in RECURRENT:
        cfg, m, r0, c0 = mixer_ckpt_reference(arch)

        def eng(mesh=None, **kw):
            return InferenceEngine("e", cfg, m, ucfg, device="cpu",
                                   mesh=mesh, **kw)
        d12 = os.path.join(arg, arch + "12")
        e12 = eng(m12, **MIX_CKPT)
        r = e12.generate(PROMPTS, 6, return_state=True)
        tie_aware(r, r0, f"{arch} ckpt (1,2) generate")
        check_state_shapes(cfg, e12.pool.arrays, m12)
        e12.checkpoint_session(r["state"], d12)
        c12 = e12.generate(None, 5, state=r["state"])
        tie_aware(c12, c0, f"{arch} ckpt (1,2) uninterrupted")
        if rank == 0:
            np.savez(d12 + ".npz", tokens=c12["tokens"],
                     logits=c12["logits"].numpy())
        f12 = eng(m12, **MIX_CKPT)
        x = f12.generate(None, 5, state=f12.restore_session(d12))
        np.testing.assert_array_equal(x["tokens"], c12["tokens"])
        assert torch.equal(x["logits"], c12["logits"]), \
            f"{arch} (1,2) -> (1,2)"
        for what, e in (("one device monolithic", eng()),
                        ("one device paged", eng(**MIX_CKPT)),
                        ("(2,1) monolithic", eng(m21))):
            st = e.restore_session(d12)
            if e.mesh is not None and not e.paged:
                check_state_shapes(cfg, st.cache, m21)
            x = e.generate(None, 5, state=st)
            tie_aware(x, c12, f"{arch} ckpt (1,2) paged -> {what}")
        d21 = os.path.join(arg, arch + "21")
        e21 = eng(m21)
        s21 = e21.generate(PROMPTS, 6, return_state=True)["state"]
        e21.checkpoint_session(s21, d21)
        c21 = e21.generate(None, 5, state=s21)
        e = eng(m12, **MIX_CKPT)
        x = e.generate(None, 5, state=e.restore_session(d21))
        tie_aware(x, c21, f"{arch} ckpt (2,1) monolithic -> (1,2) paged")
        if rank == 0:
            print(f"{arch} ckpt ok", flush=True)


# ---------------------------------------------------------------------------
# Training on a mesh
# ---------------------------------------------------------------------------

#: (arch, mesh, microbatches, two-hop batches): dense case (b) (llama3-8b
#: H4/K1 at model=2 and 4) and case (c) (smollm-135m H3/K1) on every 4-rank
#: shape and a pod mesh; the recurrent and MoE families on (2, 2); two-hop
#: batches (statements of 6 and 7 tokens) give the rows unequal loss-mask
#: counts, so a microbatch of other rows than one device's has another
#: token count and another loss
TRAIN_PLAN = (("llama3-8b", (2, 2), 1, False),
              ("smollm-135m", (2, 2), 1, False),
              ("llama3-8b", (1, 4), 1, False),
              ("smollm-135m", (1, 4), 1, False),
              ("llama3-8b", (4, 1), 1, False),
              ("smollm-135m", (4, 1), 1, False),
              ("llama3-8b", (2, 2, 1), 1, False),
              ("smollm-135m", (2, 2, 1), 1, False),
              ("recurrentgemma-2b", (2, 2), 1, False),
              ("mamba2-780m", (2, 2), 1, False),
              ("deepseek-moe-16b", (2, 2), 1, False),
              ("llama3-8b", (2, 2), 2, False),
              ("deepseek-moe-16b", (2, 2), 2, False),
              ("llama3-8b", (2, 2), 2, True),
              ("deepseek-moe-16b", (4, 1), 2, True))
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 32, 2


def train_mesh(shape: tuple):
    """A (data, model) mesh of ``shape``, or (pod, data, model) for three
    entries, over the whole world."""
    from repro_torch.launch import mesh as M
    names = ("pod", "data", "model")[-len(shape):]
    return M._device_mesh(tuple(shape), names)


def f32_attention(q, k, v, *, q_positions, kv_positions, causal, window,
                  q_block, kv_block):
    """``attention.chunked_attention``'s function in f32 throughout (it
    rounds q, k, v and P to bf16, as the reference does): where a split
    product's last bit differs from one device's, a bf16 rounding flips
    now and then (~1e-3 of an element's gradient), so the mesh's algebra
    is held at f32 rounding through this one."""
    B, S, H, Dh = q.shape
    K = k.shape[2]
    qr = q.float().reshape(B, S, K, H // K, Dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qr, k.float()) * Dh ** -0.5
    qp, kp = q_positions[:, None], kv_positions[None, :]
    mask = (kp >= 0).expand(S, -1)
    if causal:
        mask = mask & (qp >= kp)
    if window is not None:
        mask = mask & (qp - kp < window)
    p = torch.softmax(torch.where(mask, s, -1e30), dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(B, S, H, Dh).to(q.dtype)


def train_case(mesh, arch: str, seed: int, microbatches: int = 1,
               steps: int = TRAIN_STEPS, two_hop: bool = False):
    """The f32 smoke of ``arch`` trained on ``mesh`` from the rank's shard
    (``shard_params(..., DEFAULT_RULES)``) and its rows, against the one
    device's steps on the whole batch, MoE groups = the data shards, twice.

    With the training attention replaced by ``f32_attention`` (no bf16
    rounding), the collectives' algebra at f32 rounding: the first step's gradients of every leaf (the rank's slice
    of the whole, ``Cut.cut``) within 1e-5 of the leaf's largest
    magnitude; each step's loss, nll, aux and grad norm within rtol 1e-5,
    the same on every rank; the parameters and AdamW moments after the
    steps within 5e-3.  Then with the port's own numerics, where a
    last-bit difference of a split product flips a bf16 rounding of q, k,
    v or P now and then (one bf16 ulp, 2^-8, of an element), one step:
    its gradients within 1e-2 of the largest magnitude (~2e-3 seen), its
    grad norm within rtol 2e-4 (~4e-5 seen), its loss as before, and the
    parameters and moments after it within 5e-3 (later steps drift by
    ~1e-5-5e-4 from one device's: Adam moves an element whose gradient is
    near 0 by ~lr whatever its sign).  Returns the collective counts of
    the first run's steps."""
    from repro_torch.models import attention as A
    chunked, A.chunked_attention = A.chunked_attention, f32_attention
    try:
        counts = _train_run(mesh, arch, seed, microbatches, steps, 1e-5,
                            1e-5, two_hop)
    finally:
        A.chunked_attention = chunked
    _train_run(mesh, arch, seed, microbatches, 1, 1e-2, 2e-4, two_hop)
    return counts


def _train_run(mesh, arch: str, seed: int, microbatches: int, steps: int,
               grad_tol: float, norm_tol: float, two_hop: bool) -> dict:
    import copy
    from repro_torch.data.pipeline import (SyntheticLMPipeline,
                                           device_put_batch)
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import data_shards
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train as TR
    cfg, whole = mixer_model(arch, torch.float32, seed)
    groups = data_shards(mesh) if cfg.num_experts else 1
    oc = opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    pipe = SyntheticLMPipeline(TRAIN_B, TRAIN_S, two_hop=two_hop, seed=seed)
    host = [pipe.get_batch(i) for i in range(steps)]
    if two_hop:
        rows = host[0]["loss_mask"].sum(1)
        assert len(set(rows.tolist())) > 1, rows
    ref = copy.deepcopy(whole)
    rstate = opt.init(ref)
    comm = sh.Comm(mesh)
    shard = T.shard_params(copy.deepcopy(whole), cfg, mesh, comm,
                           rules=sh.DEFAULT_RULES)
    sstate = opt.init(shard)
    what = (f"{arch} {tuple(mesh.shape)} mb={microbatches} two_hop={two_hop}"
            f" tol={grad_tol}")

    def loss(c):
        return lambda m, b: T.loss_fn(m, c, b, moe_groups=groups)

    (_, _), gw = TR.value_and_grad(loss(cfg), ref, device_put_batch(
        host[0], "cpu"), has_aux=True)
    (_, _), gs = TR.value_and_grad(loss(shard.cfg), shard, device_put_batch(
        host[0], mesh, "cpu"), has_aux=True)
    opt.sync_grads(gs, shard.cuts, comm)
    for n, g in gs.items():
        want = shard.cuts[n].cut(gw[n], mesh)
        assert g.shape == want.shape, (what, n, g.shape, want.shape)
        err = float((g - want).abs().max())
        assert err <= grad_tol * float(gw[n].abs().max()) + 1e-30, (
            what, n, err, float(gw[n].abs().max()))
    comm.reset()
    rstep = TR.build_train_step(cfg, oc, microbatches=microbatches,
                                moe_groups=groups)
    sstep = TR.build_train_step(cfg, oc, mesh, microbatches=microbatches,
                                moe_groups=groups)
    for i in range(steps):
        _, _, mr = rstep(ref, rstate, device_put_batch(host[i], "cpu"))
        _, _, ms = sstep(shard, sstate, device_put_batch(host[i], mesh,
                                                         "cpu"))
        for k in ("loss", "nll", "moe_aux", "grad_norm", "tokens"):
            a, b = float(mr[k]), float(ms[k])
            tol = norm_tol if k == "grad_norm" else 1e-5
            assert abs(a - b) <= tol * abs(a) + 1e-9, (what, i, k, a, b)
            assert _same_everywhere([b]) == [[b]] * dist.get_world_size(), k
    counts = dict(comm.stats)
    named = dict(ref.named_parameters())
    for n, p in shard.named_parameters():
        c = shard.cuts[n]
        for got, want in ((p, named[n]), (sstate.m[n], rstate.m[n]),
                          (sstate.v[n], rstate.v[n])):
            err = float((got - c.cut(want, mesh)).abs().max())
            assert err <= 5e-3, (what, n, err)
    return counts


def fsdp_slices(mesh):
    """The training shard's leaves (``DEFAULT_RULES``: d_model over 'data',
    FSDP) are the spec slices of the whole, bitwise, every leaf of the
    dense smoke (case (b) keeps every KV head, as the spec replicates
    them), and ``Cut.join`` gives the whole back."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import transformer as T
    cfg, whole = model("llama3-8b", torch.float32, 3)
    comm = sh.Comm(mesh)
    shard = T.shard_params(whole, cfg, mesh, comm, rules=sh.DEFAULT_RULES)
    axes = T.param_axes(whole)
    local = dict(shard.named_parameters())
    cut = 0
    for n, p in whole.named_parameters():
        spec = sh.spec_for(p.shape, axes[n], mesh,
                           sh.DEFAULT_RULES.param_rules)
        want = p[sh.local_slices(p.shape, spec, mesh)]
        assert torch.equal(local[n], want), n
        assert torch.equal(shard.cuts[n].join(local[n], comm), p), n
        cut += local[n].numel() < p.numel()
    assert cut > len(local) // 2, (cut, len(local))


def run_train(rank: int, world: int, arg=None):
    """Every ``TRAIN_PLAN`` case (``train_case``); ``arg`` picks the cases
    by arch."""
    for i, (arch, shape, mb, two_hop) in enumerate(TRAIN_PLAN):
        if arg and arch not in arg.split(","):
            continue
        mesh = train_mesh(shape)
        counts = train_case(mesh, arch, seed=i, microbatches=mb,
                            two_hop=two_hop)
        if rank == 0:
            print(f"train {arch} {shape} mb={mb} two_hop={two_hop} ok: "
                  f"{counts['all_reduce']} all-reduces, "
                  f"{counts['all_gather']} all-gathers", flush=True)


def run_train_jax(rank: int, world: int, arg: str):
    """``arg``/weights.pt (the JAX package's smoke llama3-8b weights, f32,
    converted; ``arg``/batches.npz its batches): 2 f32 AdamW steps on the
    (2, 2) mesh; rank 0 writes the losses and the whole parameters after
    the steps (``Cut.join``) to ``arg``/out.pt for the test to hold to the
    JAX package's one-device steps."""
    from repro_torch import configs as C
    from repro_torch.data.pipeline import device_put_batch
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train as TR
    cfg = dataclasses.replace(C.get_smoke("llama3-8b"), vocab_size=512,
                              dtype=torch.float32)
    whole = T.Transformer(cfg)
    whole.load_state_dict(torch.load(os.path.join(arg, "weights.pt")))
    mesh = train_mesh((2, 2))
    comm = sh.Comm(mesh)
    shard = T.shard_params(whole, cfg, mesh, comm, rules=sh.DEFAULT_RULES)
    state = opt.init(shard)
    step = TR.build_train_step(cfg, opt.AdamWConfig(lr=1e-3), mesh)
    with np.load(os.path.join(arg, "batches.npz")) as z:
        host = [{k[2:]: z[k] for k in z.files if k[0] == str(i)}
                for i in range(2)]
    losses = []
    for b in host:
        _, _, m = step(shard, state, device_put_batch(b, mesh, "cpu"))
        losses.append(float(m["loss"]))
    out = {n: shard.cuts[n].join(p, comm)
           for n, p in shard.named_parameters()}
    if rank == 0:
        torch.save({"losses": losses, "params": out},
                   os.path.join(arg, "out.pt"))
        print(f"train_jax losses {losses}", flush=True)


def run_train_cli(rank: int, world: int, arg: str):
    """``launch.train.main([... "--mesh", "--device", "cpu"])`` on the two
    ranks' (1, 2) mesh: 4 steps with a checkpoint every 2, then a run
    resumed from that run's step 2 to 4, whose step_4 is bitwise the
    straight run's; then the straight run's step_4 restored onto the
    (2, 1) mesh (FSDP) and onto one device is the same whole tree, and
    saved again from (2, 1) it writes the same files' leaves."""
    import shutil
    from repro_torch import configs as C
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import train as LT
    from repro_torch.models import transformer as T
    from repro_torch.training import checkpoint as ck
    from repro_torch.training import optimizer as opt
    # the smoke at vocabulary 512, which covers the fact world's tokens
    # (the CLI reads configs.get_smoke)
    smoke = C.get_smoke
    C.get_smoke = lambda a: dataclasses.replace(smoke(a), vocab_size=512)
    straight, resumed = os.path.join(arg, "a"), os.path.join(arg, "b")
    base = ["--arch", "llama3-8b", "--smoke", "--batch", "4", "--seq", "32",
            "--mesh", "--steps", "4", "--ckpt-every", "2", "--seed", "3",
            "--device", "cpu"]
    LT.main(base + ["--ckpt-dir", straight])
    if rank == 0:
        os.makedirs(resumed)
        shutil.copytree(ck.step_path(straight, 2), ck.step_path(resumed, 2))
        with open(os.path.join(resumed, "LATEST"), "w") as f:
            f.write("2")
    dist.barrier()
    LT.main(base + ["--ckpt-dir", resumed, "--resume"])
    a, _ = ck.load_leaves(straight, 4)
    b, _ = ck.load_leaves(resumed, 4)
    assert sorted(a) == sorted(b)
    for k in a:
        assert _bits_equal(a[k], b[k]), k
    cfg = C.get_smoke("llama3-8b")
    mesh = train_mesh((2, 1))
    comm = sh.Comm(mesh)
    shard = T.shard_params(T.Transformer(cfg), cfg, mesh, comm,
                           rules=sh.DEFAULT_RULES)
    tree = {"params": shard, "opt": opt.init(shard)}
    ck.restore(straight, 4, tree)
    assert tree["opt"].step == 4
    whole = ck._whole_leaves(tree, shard)
    for k in a:
        assert _bits_equal(a[k], whole[k]), ("(2, 1)", k)
    ck.save(os.path.join(arg, "c"), 4, tree, extra={"step": 4})
    c, _ = ck.load_leaves(os.path.join(arg, "c"), 4)
    for k in a:
        assert _bits_equal(a[k], c[k]), ("(2, 1) saved", k)
    if rank == 0:
        one = T.Transformer(cfg)
        tree1 = {"params": one, "opt": opt.init(one)}
        ck.restore(straight, 4, tree1)
        for k, v in ck._flatten(tree1).items():
            assert _bits_equal(a[k], v), ("one device", k)
        print("train cli ok", flush=True)


def compress_inputs(rank: int):
    """(g, err) of participant ``rank`` of the compression test, f32 numpy
    from a seed: gradients of different scales per rank, a small residual
    carried in."""
    rng = np.random.default_rng(100 + rank)
    g = rng.standard_normal((33, 17)).astype(np.float32) * (rank + 1)
    err = rng.standard_normal((33, 17)).astype(np.float32) * 1e-2
    return g, err


def run_compress(rank: int, world: int, arg: str):
    """``compression.compressed_psum`` over the two ranks' 'data' axis;
    rank 0 writes every rank's reduced mean and new residual to
    ``arg``/out.npz."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.training import compression as G
    comm = sh.Comm(train_mesh((2, 1)))
    g, err = compress_inputs(rank)
    mean, new_err = G.compressed_psum(torch.from_numpy(g),
                                      torch.from_numpy(err), comm, "data")
    assert comm.stats["all_reduce"] == 3, comm.stats
    outs = [None] * world
    dist.all_gather_object(outs, (mean.numpy(), new_err.numpy()))
    if rank == 0:
        np.savez(os.path.join(arg, "out.npz"),
                 **{f"mean{r}": m for r, (m, _) in enumerate(outs)},
                 **{f"err{r}": e for r, (_, e) in enumerate(outs)})
        print("compress ok", flush=True)


def _bits_equal(x, y) -> bool:
    if isinstance(x, int) or isinstance(y, int):
        return x == y
    return x.dtype == y.dtype and torch.equal(
        x.view(torch.int16) if x.dtype == torch.bfloat16 else x,
        y.view(torch.int16) if y.dtype == torch.bfloat16 else y)


#: job -> (ranks, function); a function takes (rank, world, argument)
JOBS = {"engines": (4, "run_engines"), "gateway": (2, "run_gateway"),
        "paged": (4, "run_paged"), "lockstep": (2, "run_lockstep"),
        "ckpt": (4, "run_ckpt"), "paged_gateway": (2, "run_paged_gateway"),
        "cli": (2, "run_cli"), "mixers": (4, "run_mixers"),
        "mixers_ckpt": (2, "run_mixers_ckpt"), "train": (4, "run_train"),
        "train_jax": (4, "run_train_jax"), "train_cli": (2, "run_train_cli"),
        "compress": (2, "run_compress")}


def _rank(rank: int, job: str, world: int, store: str, arg):
    torch.set_num_threads(1)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        globals()[JOBS[job][1]](rank, world, arg)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main(job: str, arg=None):
    world = JOBS[job][0]
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank, args=(job, world, os.path.join(tmp, "s"),
                                        arg),
                           nprocs=world, start_method="spawn")
    print("RESULT ok", flush=True)


if __name__ == "__main__":
    main(*sys.argv[1:])
