"""The gateway (Algorithm 1) on paged engines: the port's
``build_gateway(..., engine_kw=dict(paged=True, pool_blocks=1024))``
against the JAX gateway on paged engines, and against the port's own
monolithic gateway.

The tiers, weights, thresholds and the study workload are those of
tests/test_torch_gateway.py (the f32 smoke gateway, thresholds at the
midpoints of the widest gaps of the JAX u and s, ``_gap_mid``); only the
engines change.  Every engine of both sides serves off its own 1024-block
pool, as the reference CLI's ``--paged`` builds them, with the default
``attn_decode_impl`` ("kernel": the block-table op, its plain version on
the CPU).  ``serving/gateway.py`` and ``serving/swarm.py`` are unchanged:
the probe's handoff to the swarm round goes through ``state_select``,
which a paged engine answers with a refcounted table copy.

Budgets as in tests/test_torch_gateway.py (decisions, answers and
counters equal; u 1e-4, s 1e-5); paged against monolithic in the port,
u to 1e-5 (the same model, keys attended in another order).
"""

import dataclasses

import pytest

from test_torch_gateway import (QUERIES, _assert_logs_equal, _run_both,  # noqa
                                f32)

jax = pytest.importorskip("jax")

from repro.core.uncertainty import UncertaintyConfig as JU  # noqa: E402
from repro.data.workload import FACT_IS  # noqa: E402
from repro.serving import gateway as JG  # noqa: E402
from repro.serving.engine import InferenceEngine as JE  # noqa: E402
from repro.serving.simulator import NetworkSimulator as JNS  # noqa: E402
from repro.serving.simulator import SimConfig as JSC  # noqa: E402
from repro.serving.swarm import SwarmExecutor as JSX  # noqa: E402
from repro.core.cost_model import LatencyParams as JLP  # noqa: E402
from repro_torch.core.router import SWARM  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dops  # noqa: E402
from repro_torch.launch.serve import \
    gateway_from_weights as build_gateway  # noqa: E402

ENGINE_KW = dict(paged=True, pool_blocks=1024)


def _port_gateway(tgw, engine_kw):
    """The port's gateway ``tgw`` rebuilt with ``engine_kw`` engines."""
    tm = tgw.swarm.members
    gw, _, _, _ = build_gateway(
        probe=(tm[0].cfg, tm[0].params), edge_1b=(tm[1].cfg, tm[1].params),
        edge_qwen=(tm[2].cfg, tm[2].params),
        cloud=(tgw.cloud.cfg, tgw.cloud.params),
        safety=(tgw.safety_cfg, tgw.safety_params),
        router_cfg=tgw.router_cfg, device="cpu", engine_kw=engine_kw)
    return gw


@pytest.fixture(scope="module")
def paged(f32):
    """Both gateways of ``f32`` rebuilt on paged engines (same weights,
    configs, classifier and router config)."""
    jgw, tgw = f32["jax"], f32["port"]
    ucfg = JU(alpha=1.0, mode="distribution")

    def jeng(e):
        return JE(e.name, e.cfg, e.params, ucfg, **ENGINE_KW)
    jm = [jeng(e) for e in jgw.swarm.members]
    jpaged = JG.Gateway(
        probe=jm[0], swarm=JSX(jm, stop_token=FACT_IS),
        cloud=jeng(jgw.cloud), safety_params=jgw.safety_params,
        safety_cfg=jgw.safety_cfg, router_cfg=jgw.router_cfg,
        sim=JNS(JSC(), JLP(), 3), budget_total=1.0)
    return {"jax": jpaged, "port": _port_gateway(tgw, ENGINE_KW),
            "mono": tgw}


def test_engines_are_paged(paged):
    gw = paged["port"]
    for eng in list(gw.swarm.members) + [gw.cloud]:
        assert eng.paged and eng.attn_decode_impl == "kernel"
        assert eng.pool.n_blocks == 1024
    assert gw.probe is gw.swarm.members[0]


def test_paged_answer_batch_matches_jax(paged):
    dops.counts.reset()
    dops.paged_counts.reset()
    j, t = _run_both(paged)
    _assert_logs_equal(j, t)
    # every tier decoded through the block-table op, none through the
    # monolithic one
    assert dops.paged_counts.plain > 0 and dops.counts.plain == 0
    assert len(set(t.decision.tolist())) >= 3


def test_paged_equals_monolithic_gateway(paged):
    mono = _run_both({"jax": paged["jax"], "port": paged["mono"]})[1]
    pag = _run_both(paged)[1]
    _assert_logs_equal(mono, pag, u_tol=1e-5, s_tol=0.0)


def test_paged_swarm_round_issues_zero_probe_prefill(paged):
    """One answer_batch prefills the paged probe once with every non-risk
    query forced into the swarm round: the round reuses the probe's
    generation through a table-copy ``state_select``."""
    gw = paged["port"]
    probe = gw.probe
    old = gw.router_cfg
    gw.router_cfg = dataclasses.replace(old, tau_low=-1.0, tau_high=2.0)
    try:
        gw.reset_fault_state()
        before = dict(probe.counters)
        copies = probe.pool.counters["row_copies"]
        log = gw.answer_batch(QUERIES[:30])
    finally:
        gw.router_cfg = old
    assert (log.decision == SWARM).sum() >= 10
    assert probe.counters["prefill"] == before["prefill"] + 1
    assert probe.counters["decode_only"] == before["decode_only"]
    assert probe.counters["grow_copy"] == 0
    assert probe.pool.counters["row_copies"] > copies      # select ran


def test_paged_batches_release_their_handles(paged):
    """21 batches through a paged port gateway whose probe pool would run
    out if the batches kept their handles (the reference's gateway keeps
    them): after every batch the probe's blocks in use are back at their
    baseline, no ``PoolExhaustedError`` is raised, and each batch's log
    equals the JAX paged gateway's, batch for batch."""
    n_blocks = 48
    small = _port_gateway(paged["mono"], dict(paged=True,
                                               pool_blocks=n_blocks))
    probe = small.probe
    at_release = []       # per batch: blocks in use at each release
    release = probe.release

    def counting_release(state):
        at_release[-1].append(probe.pool.blocks_in_use)
        release(state)
    probe.release = counting_release
    base = probe.pool.blocks_in_use
    for _ in range(21):
        at_release.append([])
        j, t = _run_both({"jax": paged["jax"], "port": small},
                         queries=QUERIES[:10])
        _assert_logs_equal(j, t)
        assert probe.pool.blocks_in_use == base
        assert probe.pool.live_sessions == 0
    assert (t.decision == SWARM).any()
    # what the batches' handles held: more than the pool has
    assert sum(b[0] - base for b in at_release) > n_blocks - base
