"""Training entry point: --arch config, train loop, checkpoint/restart
(PyTorch port of ``repro/launch/train.py``, one device).

Fault tolerance:
  * atomic checkpoints every --ckpt-every steps (``training/checkpoint``)
  * --resume restores the latest checkpoint; the data pipeline is a pure
    function of step, so the token stream replays exactly

Runs on the card (no card raises); ``main(argv, device="cpu")`` runs on the
CPU.  Mesh-sharded training (the reference's ``--mesh``) is not ported.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --steps 40 --batch 8 --seq 128 --ckpt-dir build/ck --ckpt-every 20
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs as C
from repro_torch.data.pipeline import SyntheticLMPipeline, device_put_batch
from repro_torch.models import transformer as T
from repro_torch.models.common import resolve_device, use_f32_accumulation
from repro_torch.training import checkpoint as ck
from repro_torch.training import optimizer as opt
from repro_torch.training import train as TR


def main(argv=None, device=None):
    """Train, printing ``[train] step N loss L`` every 10 steps; returns the
    trained model."""
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
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(device, "launch.train")
    if device.type == "cuda":
        use_f32_accumulation()
    cfg = C.get_smoke(args.arch) if args.smoke else C.get_config(args.arch)
    ocfg = opt.AdamWConfig(lr=args.lr, total_steps=args.steps,
                           warmup_steps=max(args.steps // 10, 1))
    step_fn = TR.build_train_step(cfg, ocfg, microbatches=args.microbatches)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = T.init_params(cfg, gen, device=device)
    state = opt.init(model)
    start = 0
    if args.ckpt_dir and args.resume:
        latest = ck.latest_step(args.ckpt_dir)
        if latest is not None:
            _, extra = ck.restore(args.ckpt_dir, latest,
                                  {"params": model, "opt": state})
            start = int(extra["step"]) if "step" in extra else latest
            print(f"[train] resumed from step {start}", flush=True)

    pipe = SyntheticLMPipeline(args.batch, args.seq, two_hop=args.two_hop,
                               seed=args.seed)
    metrics = None
    t0 = time.time()
    for step in range(start, args.steps):
        batch = device_put_batch(pipe.get_batch(step), device)
        model, state, metrics = step_fn(model, state, batch)
        if step % 10 == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            print(f"[train] step {step} loss {loss:.4f} "
                  f"({(time.time() - t0):.1f}s)", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            ck.save(args.ckpt_dir, step + 1, {"params": model, "opt": state},
                    extra={"step": step + 1})
            print(f"[train] checkpoint @ {step + 1}", flush=True)
    if args.ckpt_dir:
        ck.save(args.ckpt_dir, args.steps, {"params": model, "opt": state},
                extra={"step": args.steps})
    if metrics is not None:
        print(f"[train] done: final loss {float(metrics['loss']):.4f}")
    return model


if __name__ == "__main__":
    main()
