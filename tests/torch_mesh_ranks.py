"""Ranks of a gloo world on the CPU for ``test_torch_mesh_engine.py``: the
port's mesh-sharded engine and gateway against its single-device ones.

    python tests/torch_mesh_ranks.py engines   # 4 ranks: (2,2), (1,4), (4,1)
    python tests/torch_mesh_ranks.py gateway   # 2 ranks: (1,2)

Spawns its ranks over a ``FileStore`` in a temporary directory (no socket
but gloo's own on the loopback device); every rank builds the same
seeded weights, a single-device engine and the mesh engine, and checks on
its own.  A failed check in any rank fails the run; rank 0 prints
``RESULT ok`` at the end.  Imports torch and the port only (no JAX), so a
rank starts in a few seconds.
"""

from __future__ import annotations

import dataclasses
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
    """Each leaf of the rank's shard is the full leaf divided as its spec
    says, but for case (b)'s one KV head."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import transformer as T
    axes = T.param_axes(full)
    cfg = eng.cfg
    local = dict(eng.params.named_parameters())
    for name, p in full.named_parameters():
        spec = sh.spec_for(p.shape, axes[name], mesh,
                           sh.SERVE_RULES.param_rules)
        want = [n // sh.shard_index(spec[d] if d < len(spec) else None,
                                    mesh)[1] for d, n in enumerate(p.shape)]
        leaf = name.rsplit(".", 1)[-1]
        kv_dim = {"wk": 1, "wv": 1, "bk": 0, "bv": 0}.get(leaf)
        if kv_dim is not None and eng._mcfg.num_kv_heads != cfg.num_kv_heads \
                and want[kv_dim] == cfg.num_kv_heads:
            want[kv_dim] = 1                                    # case (b)
        assert tuple(local[name].shape) == tuple(want), \
            (name, tuple(local[name].shape), want, spec)
    return sum(t.nbytes for t in local.values())


def engines_case(mesh, arch: str, seed: int):
    from repro_torch.core.uncertainty import UncertaintyConfig
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.scheduler import Request
    ucfg = UncertaintyConfig(mode="distribution")
    for dtype in (torch.bfloat16, torch.float32):
        cfg, m = model(arch, dtype, seed)
        base = InferenceEngine(arch, cfg, m, ucfg, device="cpu")
        shard = InferenceEngine(arch, cfg, m, ucfg, device="cpu", mesh=mesh)
        check_local_shapes(shard, m, mesh)
        tag = f"{arch} {dtype} {dict(zip(mesh.mesh_dim_names, mesh.shape))}"
        r0 = base.generate(PROMPTS, 8, return_state=True)
        r1 = shard.generate(PROMPTS, 8, return_state=True)
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


def run_engines(rank: int, world: int, store: str):
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
    cache; the FSDP rules (DEFAULT_RULES cut d_model over 'data') are not
    ported.  Both raise NotImplementedError naming what is missing."""
    from repro_torch import configs as C
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import InferenceEngine
    odd = dataclasses.replace(C.get_smoke("swarm-edge-1b"), num_heads=6,
                              num_kv_heads=3)
    llama = C.get_smoke("llama3-8b")
    for build, what in (
            (lambda: InferenceEngine("x", odd, T.Transformer(odd),
                                     device="cpu", mesh=mesh),
             "sequence-sharded"),
            (lambda: T.shard_params(T.Transformer(llama), llama, mesh,
                                    rules=sh.DEFAULT_RULES), "FSDP")):
        try:
            build()
        except NotImplementedError as e:
            assert what in str(e), (what, str(e))
        else:
            raise AssertionError(f"no refusal: {what}")


def run_gateway(rank: int, world: int, store: str):
    """The four f32 tiers and the classifier through ``gateway_from_weights``
    with fixed thresholds (no calibration), single device and on the (1, 2)
    mesh: the same decisions, answers and emitted tokens."""
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
            calibrate=False, mesh=m,
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
        print(f"gateway decisions {np.bincount(a.decision).tolist()} ok",
              flush=True)


def _rank(rank: int, job: str, world: int, store: str):
    torch.set_num_threads(1)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        (run_engines if job == "engines" else run_gateway)(rank, world,
                                                           store)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main(job: str):
    world = {"engines": 4, "gateway": 2}[job]
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank, args=(job, world, os.path.join(tmp, "s")),
                           nprocs=world, start_method="spawn")
    print("RESULT ok", flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
