"""Event-level network / failure simulator (paper Sec. III-B environment).

The port's own copy of ``repro/serving/simulator.py`` (numpy only), over
the port's ``LatencyParams``.  It draws from its numpy RNG in the same
order, so a seeded run gives the reference's latencies exactly.

The prototype measured wall-clock on one desktop; this container is CPU-only,
so end-to-end latencies come from a calibrated stochastic model instead
(constants in core/cost_model.LatencyParams, fitted to Table III):

  * WAN: lognormal RTT + two-state Markov availability (outages, O5 tests)
  * local links: per-peer Gaussian jitter (Eq. 9's L_comm)
  * nodes: per-tick Bernoulli failure AND recovery — a down node comes
    back with probability ``node_recover_p`` each tick, i.e. downtime is
    geometrically distributed with mean ``1 / node_recover_p`` ticks
    (the discrete-time analogue of exponential recovery; see
    ``SimConfig.mean_ticks_to_recover``).  The WAN uses the same
    two-state chain with ``wan_outage_p`` / ``wan_recover_p``.

All routing/consensus/budget code that the simulator drives is the REAL
production code — only link/compute *timings* are synthetic.  Failures
here only shape *availability and latency accounting*; execution-level
failures (a member call actually raising mid-round) are injected by
serving/faults.py.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.cost_model import LatencyParams


@dataclasses.dataclass
class SimConfig:
    """Two-state Markov availability knobs, one tick per gateway batch.

    All four transition probabilities are per-tick Bernoulli draws, so
    sojourn times are geometric: a WAN outage lasts ``1/wan_recover_p``
    ticks in expectation, a node outage ``1/node_recover_p`` ticks.
    """

    seed: int = 0
    wan_outage_p: float = 0.02       # P(up -> down) per tick
    wan_recover_p: float = 0.5       # P(down -> up) per tick
    node_fail_p: float = 0.0         # P(up -> down) per tick, per member
    node_recover_p: float = 0.5      # P(down -> up) per tick, per member
    straggler_p: float = 0.05        # peer responds ~5x slower
    straggler_mult: float = 5.0

    def mean_ticks_to_recover(self, kind: str = "node") -> float:
        """Expected outage length in ticks (geometric mean sojourn):
        ``1 / recover_p``, infinite when recovery is disabled."""
        p = self.node_recover_p if kind == "node" else self.wan_recover_p
        return float("inf") if p <= 0 else 1.0 / p


class NetworkSimulator:
    def __init__(self, cfg: SimConfig, lat: LatencyParams, n_members: int):
        self.cfg = cfg
        self.lat = lat
        self.n_members = n_members
        self.reset()

    def reset(self):
        """Rewind to the seeded initial state (determinism re-runs)."""
        self.rng = np.random.RandomState(self.cfg.seed)
        self.wan_up = True
        self.member_up = np.ones((self.n_members,), bool)

    # --- state evolution (called once per query/batch tick) ---------------
    def tick(self):
        c = self.cfg
        if self.wan_up:
            self.wan_up = self.rng.rand() >= c.wan_outage_p
        else:
            self.wan_up = self.rng.rand() < c.wan_recover_p
        for j in range(len(self.member_up)):
            if self.member_up[j]:
                self.member_up[j] = self.rng.rand() >= c.node_fail_p
            else:
                self.member_up[j] = self.rng.rand() < c.node_recover_p

    # --- latency samples ----------------------------------------------------
    def wan_rtt(self, n: int) -> np.ndarray:
        mu, sd = self.lat.wan_rtt_mean, self.lat.wan_rtt_std
        sigma2 = np.log(1 + (sd / mu) ** 2)
        return self.rng.lognormal(np.log(mu) - sigma2 / 2, np.sqrt(sigma2), n)

    def peer_comm(self, n_queries: int, n_members: int) -> np.ndarray:
        base = np.abs(self.rng.normal(self.lat.comm_peer_mean,
                                      self.lat.comm_peer_std,
                                      (n_queries, n_members)))
        straggle = self.rng.rand(n_queries, n_members) < self.cfg.straggler_p
        return np.where(straggle, base * self.cfg.straggler_mult, base)

    def edge_latency(self, token_counts: np.ndarray) -> np.ndarray:
        sg = self.lat.edge_jitter_sigma
        jitter = self.rng.lognormal(-sg * sg / 2, sg, np.shape(token_counts))
        return (self.lat.edge_prefill
                + self.lat.edge_per_token * token_counts) * jitter

    def cloud_latency(self, token_counts: np.ndarray) -> np.ndarray:
        return self.wan_rtt(len(np.atleast_1d(token_counts))) \
            + self.lat.cloud_per_token * token_counts
