"""Training entry point: --arch config, train loop, checkpoint/restart
(PyTorch port of ``repro/launch/train.py``).

Fault tolerance:
  * atomic checkpoints every --ckpt-every steps (``training/checkpoint``)
  * --resume restores the latest checkpoint; the data pipeline is a pure
    function of step, so the token stream replays exactly
  * with --mesh, checkpoints hold the whole tree, so a run resumes on
    whatever mesh ``elastic_mesh()`` finds (restore-time elasticity)

Runs on the card (no card raises); ``main(argv, device="cpu")`` runs on the
CPU.  ``--mesh`` trains FSDP x TP over an ``elastic_mesh()`` of the live
ranks (``torchrun`` starts them; a world of one is the (1, 1) mesh), each
rank on its shard (``transformer.shard_params`` under ``DEFAULT_RULES``)
and its rows, MoE groups = the data shards; only rank 0 prints.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --steps 40 --batch 8 --seq 128 --ckpt-dir build/ck --ckpt-every 20
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
      --device cpu --smoke --mesh --steps 20
"""

from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from repro_torch import configs as C
from repro_torch.data.pipeline import SyntheticLMPipeline, device_put_batch
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import data_shards, elastic_mesh
from repro_torch.models import transformer as T
from repro_torch.models.common import resolve_device, use_f32_accumulation
from repro_torch.training import checkpoint as ck
from repro_torch.training import optimizer as opt
from repro_torch.training import train as TR


def main(argv=None, device=None):
    """Train, printing ``[train] step N loss L`` every 10 steps; returns the
    trained model (with --mesh the rank's shard)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--two-hop", action="store_true",
                    help="include 2-hop facts (cloud-tier curriculum)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--mesh", action="store_true",
                    help="shard over an elastic mesh of the live ranks")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the card)")
    args = ap.parse_args(argv)

    device = resolve_device(device or args.device, "launch.train")
    if device.type == "cuda":
        use_f32_accumulation()
    cfg = C.get_smoke(args.arch) if args.smoke else C.get_config(args.arch)
    mesh = elastic_mesh(device=device) if args.mesh else None
    say = mesh is None or dist.get_rank() == 0
    ocfg = opt.AdamWConfig(lr=args.lr, total_steps=args.steps,
                           warmup_steps=max(args.steps // 10, 1))
    step_fn = TR.build_train_step(
        cfg, ocfg, mesh, microbatches=args.microbatches,
        moe_groups=data_shards(mesh) if mesh is not None else 1)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = T.init_params(cfg, gen, device=device)
    if mesh is not None:
        model = T.shard_params(model, cfg, mesh, sh.Comm(mesh),
                               rules=sh.DEFAULT_RULES)
    state = opt.init(model)
    start = 0
    if args.ckpt_dir and args.resume:
        latest = ck.latest_step(args.ckpt_dir)
        if latest is not None:
            _, extra = ck.restore(args.ckpt_dir, latest,
                                  {"params": model, "opt": state})
            start = int(extra["step"]) if "step" in extra else latest
            if say:
                print(f"[train] resumed from step {start}", flush=True)

    pipe = SyntheticLMPipeline(args.batch, args.seq, two_hop=args.two_hop,
                               seed=args.seed)
    metrics = None
    t0 = time.time()
    for step in range(start, args.steps):
        host = pipe.get_batch(step)
        batch = (device_put_batch(host, device) if mesh is None
                 else device_put_batch(host, mesh, device))
        model, state, metrics = step_fn(model, state, batch)
        if say and (step % 10 == 0 or step == args.steps - 1):
            loss = float(metrics["loss"])
            print(f"[train] step {step} loss {loss:.4f} "
                  f"({(time.time() - t0):.1f}s)", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            ck.save(args.ckpt_dir, step + 1, {"params": model, "opt": state},
                    extra={"step": step + 1})
            if say:
                print(f"[train] checkpoint @ {step + 1}", flush=True)
    if args.ckpt_dir:
        ck.save(args.ckpt_dir, args.steps, {"params": model, "opt": state},
                extra={"step": args.steps})
    if say and metrics is not None:
        print(f"[train] done: final loss {float(metrics['loss']):.4f}")
    return model


if __name__ == "__main__":
    main()
