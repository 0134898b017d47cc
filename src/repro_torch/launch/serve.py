"""Serving entry point: stand up the full SWARM-LLM gateway on trained
smoke tiers (PyTorch port of ``repro/launch/serve.py``).

``build_gateway`` trains the three-tier swarm (probe + 2 peers, 1-hop
curriculum), the cloud FM tier (1+2-hop curriculum) and the safety
classifier at the reference's smoke widths (vocabulary 512), calibrates
tau, and assembles the gateway (``gateway_from_weights``, which also takes
given weights: converted JAX weights in the tests, published-width random
weights on the card).  ``main()`` routes the paper's 50-query study
workload and prints the Table III/IV/V metrics.  Everything runs on the
card unless the caller passes ``device="cpu"``.

  PYTHONPATH=src python -m repro_torch.launch.serve --train-steps 400
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import configs as C
from repro_torch.core import safety as safety_lib
from repro_torch.core.cost_model import LatencyParams
from repro_torch.core.router import RouterConfig
from repro_torch.core.uncertainty import UncertaintyConfig
from repro_torch.data.pipeline import SyntheticLMPipeline, device_put_batch
from repro_torch.data.workload import FACT_IS, FactWorld
from repro_torch.models import transformer as T
from repro_torch.models.common import (ModelConfig, resolve_device,
                                       use_f32_accumulation)
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.gateway import Gateway, run_cloud_only, run_edge_only
from repro_torch.serving.simulator import NetworkSimulator, SimConfig
from repro_torch.serving.swarm import SwarmExecutor, pad_prompts
from repro_torch.training import optimizer as opt
from repro_torch.training import train as TR

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


def _train_device(device) -> torch.device:
    device = resolve_device(device, "training")
    if device.type == "cuda":
        use_f32_accumulation()
    return device


def train_lm(arch: str, steps: int, *, two_hop: bool, seed: int,
             batch: int = 16, seq: int = 64, lr: float = 1e-2,
             num_layers: int | None = None, world: FactWorld | None = None,
             device=None, losses: list | None = None):
    """Train ``arch``'s smoke config at vocabulary 512 for ``steps`` AdamW
    steps on the fact-world stream; returns (cfg, model).  ``losses``, if
    given, receives every step's loss (device tensors)."""
    device = _train_device(device)
    cfg = dataclasses.replace(C.get_smoke(arch), vocab_size=512)
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    ocfg = opt.AdamWConfig(lr=lr, total_steps=steps,
                           warmup_steps=max(steps // 10, 1), weight_decay=0.0)
    step_fn = TR.build_train_step(cfg, ocfg)
    model = T.init_params(cfg, torch.Generator(device=device).manual_seed(
        seed), device=device)
    state = opt.init(model)
    pipe = SyntheticLMPipeline(batch, seq, two_hop=two_hop, seed=seed,
                               world=world)
    for step in range(steps):
        b = device_put_batch(pipe.get_batch(step), device)
        model, state, m = step_fn(model, state, b)
        if losses is not None:
            losses.append(m["loss"])
    print(f"[serve] trained {arch} ({'2-hop' if two_hop else '1-hop'}) "
          f"final loss {float(m['loss']):.3f}")
    return cfg, model


def train_safety(steps: int = 150, seed: int = 5, device=None,
                 losses: list | None = None):
    """Train the safety classifier (``classifier_config(vocab_size=512)``)
    for ``steps`` AdamW steps on ``safety_training_batch(32, 6, step)``;
    returns (cfg, classifier)."""
    device = _train_device(device)
    cfg = safety_lib.classifier_config(vocab_size=512)
    params = safety_lib.init_safety(
        cfg, torch.Generator(device=device).manual_seed(seed), device=device)
    state = opt.init(params)
    trainer = safety_lib.make_trainer(cfg, lr=1e-2, steps=steps)
    world = FactWorld()
    for step in range(steps):
        # length 6 matches the study prompts: a single risk marker in a
        # short query must score below sigma (borderline cases, Table V SER)
        toks, labels = world.safety_training_batch(32, 6, step)
        params, state, loss = trainer(
            params, state, torch.as_tensor(toks, device=device),
            torch.as_tensor(labels, device=device))
        if losses is not None:
            losses.append(loss)
    print(f"[serve] safety classifier BCE {float(loss):.3f}")
    return cfg, params


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


def build_gateway(train_steps: int = 150, quorum: int | None = None,
                  sim_cfg: SimConfig | None = None,
                  router_cfg: RouterConfig | None = None,
                  budget_total: float = 1.0, seed: int = 0,
                  world: FactWorld | None = None, calibrate: bool = True,
                  engine_kw: dict | None = None, device=None):
    """Train the four tiers and the safety classifier, then construct the
    three-tier system (``gateway_from_weights``).  Returns (gateway, probe
    engine, cloud engine, world).

    The probe (the weakest member, the paper's TinyLlama analogue) trains
    3x ``train_steps`` to land near the paper's 0.45-easy edge tier; the
    cloud FM trains 2.25x with 4 layers and the 2-hop curriculum."""
    device = _train_device(device)
    # a compact fact world so the smoke-scale tiers genuinely memorise it
    world = world or FactWorld(n_ent=16, n_rel=6)
    kw = dict(world=world, device=device)
    tiers = {
        "probe": train_lm("smollm-135m", 3 * train_steps, two_hop=False,
                          seed=seed, **kw),
        "edge_1b": train_lm("swarm-edge-1b", train_steps, two_hop=False,
                            seed=seed + 1, **kw),
        "edge_qwen": train_lm("qwen1.5-110b", train_steps, two_hop=False,
                              seed=seed + 2, **kw),
        "cloud": train_lm("llama3-8b", int(2.25 * train_steps),
                          two_hop=True, seed=seed + 3, num_layers=4, **kw)}
    safety = train_safety(device=device)
    return gateway_from_weights(
        **tiers, safety=safety, router_cfg=router_cfg, device=device,
        engine_kw=engine_kw, world=world, sim_cfg=sim_cfg,
        budget_total=budget_total, quorum=quorum, calibrate=calibrate)


def gateway_from_weights(*, probe: tuple, edge_1b: tuple, edge_qwen: tuple,
                         cloud: tuple, safety: tuple,
                         router_cfg: RouterConfig | None = None, device=None,
                         engine_kw: dict | None = None,
                         world: FactWorld | None = None,
                         sim_cfg: SimConfig | None = None,
                         budget_total: float = 1.0,
                         quorum: int | None = None, calibrate: bool = True):
    """Construct the three-tier system from ``(cfg, weights)`` per tier and
    ``(cfg, classifier)`` for the safety gate.  Returns ``(gateway, probe
    engine, cloud engine, world)`` as the reference does, over ``world``
    (default: the reference's compact fact world).

    Every engine runs on ``device`` (the card when None; no card raises
    unless ``device="cpu"``), and the safety classifier is moved to the
    same device.  Without ``router_cfg``, tau comes from
    ``calibrate_thresholds`` (the default thresholds with ``calibrate``
    False).  ``engine_kw`` goes to every tier's ``InferenceEngine`` (e.g.
    ``dict(paged=True, pool_blocks=1024)``: every tier serves off its own
    block pool)."""
    world = world or FactWorld(n_ent=16, n_rel=6)
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

    rcfg = router_cfg or RouterConfig(tau_low=0.08, tau_high=0.22, sigma=0.7,
                                      peers_k=2, gamma=0.3, l_max=4.0)
    if calibrate and router_cfg is None:
        rcfg = calibrate_thresholds(probe_eng, world, rcfg)
        print(f"[serve] calibrated tau_low={rcfg.tau_low:.3f} "
              f"tau_high={rcfg.tau_high:.3f}")
    sim = NetworkSimulator(sim_cfg or SimConfig(), LatencyParams(),
                           n_members=len(peers))
    gw = Gateway(
        probe=probe_eng, swarm=SwarmExecutor(peers, stop_token=FACT_IS),
        cloud=cloud_eng, safety_params=sparams, safety_cfg=scfg,
        router_cfg=rcfg, sim=sim, budget_total=budget_total, quorum=quorum)
    return gw, probe_eng, cloud_eng, world


def tables(edge, cloud, swarm) -> str:
    """Tables III-V of the three runs' ``GatewayLog``s, as ``main()``
    prints them."""
    runs = [("Edge-Only", edge), ("Cloud-Only", cloud), ("SWARM-LLM", swarm)]
    out = ["=== Table III: latency & cloud usage ==="]
    for name, lg in runs:
        out.append(f"{name:12s} mean {lg.latency.mean():5.2f}s  "
                   f"p95 {np.percentile(lg.latency, 95):5.2f}s  "
                   f"cloud {lg.cloud_usage()*100:5.1f}%")
    out += ["", "=== Table IV: accuracy ==="]
    for name, lg in runs:
        out.append(f"{name:12s} overall {lg.accuracy():.3f}  "
                   f"easy {lg.accuracy('easy'):.3f}  "
                   f"hard {lg.accuracy('hard'):.3f}")
    out += ["", "=== Table V: privacy (normalised to cloud-only) ==="]
    pm = swarm.privacy()
    out.append(f"SWARM-LLM  CER {float(pm.cer):.3f}  TER {float(pm.ter):.3f}  "
               f"SER {float(pm.ser):.3f}")
    return "\n".join(out)


def main(argv=None, device=None):
    """The CLI: train the gateway, route the study workload, print Tables
    III-V.  Returns (gateway log, edge-only log, cloud-only log)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--train-steps", type=int, default=400)
    ap.add_argument("--quorum", type=int, default=None)
    ap.add_argument("--budget", type=float, default=1.0)
    ap.add_argument("--paged", action="store_true",
                    help="serve every tier off the paged block-pool cache")
    ap.add_argument("--attn-decode-impl", choices=("kernel", "gather"),
                    default=None,
                    help="paged decode-attention impl (implies --paged)")
    ap.add_argument("--cache-quant", choices=("int8", "fp8"), default=None,
                    help="store paged KV blocks quantized with per-row f32 "
                         "scales (implies --paged)")
    args = ap.parse_args(argv)

    engine_kw = {}
    if (args.paged or args.attn_decode_impl is not None
            or args.cache_quant is not None):
        # the study workload batches ~50 queries through each tier, well
        # past the default pool sizing (16 full-length sessions)
        engine_kw.update(paged=True, pool_blocks=1024,
                         attn_decode_impl=args.attn_decode_impl)
    if args.cache_quant is not None:
        engine_kw["cache_quant"] = args.cache_quant
    gw, probe, cloud, world = build_gateway(
        args.train_steps, args.quorum, budget_total=args.budget,
        engine_kw=engine_kw, device=device)
    queries = world.study_workload()
    log = gw.answer_batch(queries)
    # baselines graded on the SAME answer normalisation as the gateway
    stop = gw.swarm.stop_token
    edge = run_edge_only(queries, probe, gw.sim, stop_token=stop)
    cl = run_cloud_only(queries, cloud, gw.sim, stop_token=stop)
    print("\n" + tables(edge, cl, log))
    return log, edge, cl


if __name__ == "__main__":
    main()
