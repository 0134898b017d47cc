"""Serving launcher: stand up the SWARM-LLM gateway from given tier weights
(PyTorch port of ``repro/launch/serve.py``).

The reference trains the four tiers and the safety classifier before it
routes; training is not ported yet, so ``build_gateway`` takes each tier's
config and weights as arguments — weights converted from the JAX package
(``convert.from_jax_params``) in the tests, or the port's ``init_params``
on the card — and assembles the same three-tier system: the probe, a swarm
of the probe and two peers, the cloud tier, the safety classifier, the
router config and the network simulator.  The CLI ``main()`` (train, then
print the Table III-V metrics) waits for the training slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch import configs as C
from repro_torch.core.cost_model import LatencyParams
from repro_torch.core.router import RouterConfig
from repro_torch.core.uncertainty import UncertaintyConfig
from repro_torch.data.workload import FACT_IS, FactWorld
from repro_torch.models.common import ModelConfig
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.gateway import Gateway
from repro_torch.serving.simulator import NetworkSimulator, SimConfig
from repro_torch.serving.swarm import SwarmExecutor, pad_prompts

#: the gateway's tiers: name -> (arch, depth the reference's gateway builds
#: it at; None = the arch's own).  The reference serves smoke widths; the
#: port on the card serves the published widths at these depths.
TIERS = {"probe": ("smollm-135m", None),
         "edge_1b": ("swarm-edge-1b", None),
         "edge_qwen": ("qwen1.5-110b", 2),
         "cloud": ("llama3-8b", 4)}


def tier_configs() -> dict[str, ModelConfig]:
    """The four tiers' configs at published widths and the gateway's
    depths (``TIERS``)."""
    out = {}
    for name, (arch, layers) in TIERS.items():
        cfg = C.get_config(arch)
        out[name] = (cfg if layers is None
                     else dataclasses.replace(cfg, num_layers=layers))
    return out


def calibrate_thresholds(probe: InferenceEngine, world: FactWorld,
                         base: RouterConfig, n: int = 24, max_new: int = 8
                         ) -> RouterConfig:
    """Fit tau_low/tau_high from the probe's U distribution on held-out
    queries (the paper tuned its 'final experiments' thresholds the same
    way, Sec. V-C): tau_low at the 40th percentile, tau_high at the 90th."""
    qs = world.easy_queries(n, seed=101) + world.hard_queries(n, seed=102)
    res = probe.generate(pad_prompts([q["prompt"] for q in qs]), max_new)
    u = np.sort(res["u"])
    tau_low = float(np.quantile(u, 0.40))
    tau_high = float(np.quantile(u, 0.90))
    return dataclasses.replace(base, tau_low=tau_low, tau_high=tau_high)


def build_gateway(*, probe: tuple, edge_1b: tuple, edge_qwen: tuple,
                  cloud: tuple, safety: tuple,
                  router_cfg: RouterConfig | None = None, device=None,
                  engine_kw: dict | None = None):
    """Construct the three-tier system from ``(cfg, weights)`` per tier and
    ``(cfg, classifier)`` for the safety gate.  Returns ``(gateway, probe
    engine, cloud engine, world)`` as the reference does, over the
    reference's compact fact world.

    Every engine runs on ``device`` (the card when None; no card raises
    unless ``device="cpu"``), and the safety classifier is moved to the
    same device.  Without ``router_cfg``, tau comes from
    ``calibrate_thresholds``.  ``engine_kw`` goes to every tier's
    ``InferenceEngine`` (e.g. ``dict(paged=True, pool_blocks=1024)``: every
    tier serves off its own block pool)."""
    world = FactWorld(n_ent=16, n_rel=6)
    ucfg = UncertaintyConfig(alpha=1.0, mode="distribution")

    def engine(name, tier):
        cfg, params = tier
        return InferenceEngine(name, cfg, params, ucfg, device=device,
                               **(engine_kw or {}))

    probe_eng = engine("probe-smollm", probe)
    peers = [probe_eng, engine("edge-1b", edge_1b),
             engine("edge-qwen", edge_qwen)]
    cloud_eng = engine("cloud-fm", cloud)
    scfg, sparams = safety
    sparams = sparams.to(probe_eng.device)

    rcfg = router_cfg or calibrate_thresholds(
        probe_eng, world, RouterConfig(tau_low=0.08, tau_high=0.22,
                                       sigma=0.7, peers_k=2, gamma=0.3,
                                       l_max=4.0))
    sim = NetworkSimulator(SimConfig(), LatencyParams(),
                           n_members=len(peers))
    gw = Gateway(
        probe=probe_eng, swarm=SwarmExecutor(peers, stop_token=FACT_IS),
        cloud=cloud_eng, safety_params=sparams, safety_cfg=scfg,
        router_cfg=rcfg, sim=sim)
    return gw, probe_eng, cloud_eng, world
