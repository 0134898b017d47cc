"""AdamW with f32 master weights (PyTorch port of
``repro/training/optimizer.py``).

Master weights and both moments are f32 whatever the parameter dtype; the
update runs in f32 and the master is cast back into each parameter.  The
update is the reference's, not ``torch.optim.AdamW``'s (which adds its eps
elsewhere and decays before the step):

    g = g * min(1, clip / max(|g|, 1e-9))       |g| the global f32 norm
    m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g g
    master -= lr(step) * (m/(1-b1^step) / (sqrt(v/(1-b2^step)) + eps)
                          + wd * master)

with ``step`` counted from 1 and ``lr`` the schedule at the incremented
step.  The state holds one f32 tensor per parameter, keyed by the model's
parameter names, and ``apply`` updates model and state IN PLACE (the
reference's jitted step donates both buffers instead).

On a mesh the state is a rank's shard's (``init`` of the shard: ZeRO, the
moments and master cut as the parameters are), and the training step
prepares the shard's gradients first: ``sync_grads`` sums what the batch
axes left partial, and ``global_norm`` of ``shard_pieces`` counts each
element of the whole gradient once.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch.distributed import sharding as sh


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


@dataclasses.dataclass
class OptState:
    """``step``: updates applied so far; ``master``, ``m``, ``v``: f32
    tensors keyed by parameter name, on the parameters' devices."""
    step: int
    master: dict
    m: dict
    v: dict


def init(params: nn.Module) -> OptState:
    """Step 0, the master an f32 copy of every parameter, zero moments."""
    with torch.no_grad():
        named = dict(params.named_parameters())
        return OptState(
            step=0,
            master={n: p.detach().to(torch.float32, copy=True)
                    for n, p in named.items()},
            m={n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for n, p in named.items()},
            v={n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for n, p in named.items()})


def schedule(step: int, cfg: AdamWConfig) -> float:
    """Linear warm-up then cosine decay to ``min_lr_ratio``, in f32 as the
    reference computes it (python constants rounded to f32 where it rounds
    them)."""
    f = np.float32
    s = f(step)
    warm = np.minimum(s / f(max(cfg.warmup_steps, 1)), f(1.0))
    prog = np.clip((s - f(cfg.warmup_steps))
                   / f(max(cfg.total_steps - cfg.warmup_steps, 1)), f(0), f(1))
    cos = f(0.5) * (f(1) + np.cos(f(np.pi) * prog))
    return float(f(cfg.lr) * warm * (f(cfg.min_lr_ratio)
                                      + f(1 - cfg.min_lr_ratio) * cos))


def global_norm(tensors, once=None, comm=None) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor of the sequence, each
    up-cast to f32.  On a mesh the tensors are a rank's pieces of the
    whole gradient: ``once`` (a 0/1 weight per tensor, ``shard_pieces``)
    keeps out the copies another rank counts, and the sum is taken over
    every rank of ``comm``'s mesh, so each element counts once and every
    rank clips by the same scale."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    sq = torch.stack(norms).square()
    if once is not None and not all(once):
        sq = sq * torch.tensor(once, dtype=sq.dtype, device=sq.device)
    total = sq.sum()
    if comm is not None:
        total = comm.all_reduce(total, tuple(comm.sizes))
    return total.sqrt()


def _first(cut, comm) -> bool:
    """Whether this rank counts a leaf of ``cut`` in the norm: its
    coordinate is 0 on every axis (of more than one rank) that holds copies
    of it, the axes it is not cut over."""
    mine = set(cut.tp_axes) | set(cut.dp_axes)
    coord = sh.coordinates(comm.mesh)
    return all(coord[a] == 0 for a, n in comm.sizes.items()
               if n > 1 and a not in mine)


def shard_pieces(grads: dict, cuts: dict, comm) -> tuple[list, list]:
    """(tensors, once) for ``global_norm`` of a shard's gradients
    (``transformer.shard_params``'s ``cuts``): each leaf whole, weighted 1
    where this rank is its first holder, else 0; a leaf with columns other
    ranks hold too (``sharding.Cut.shared``) split in two, those columns
    counted by their first holder only."""
    out, once = [], []
    for n, g in grads.items():
        c = cuts[n]
        first = float(_first(c, comm))
        if c.shared is None:
            out.append(g)
            once.append(first)
            continue
        local, _, _, counted = c.shared
        rest = [j for j in range(g.shape[c.tp_dim]) if j not in set(local)]
        out += [sh.take_cols(g, c.tp_dim, rest),
                sh.take_cols(g, c.tp_dim, counted)]
        once += [first, first]
    return out, once


def sync_grads(grads: dict, cuts: dict, comm) -> dict:
    """Make a shard's gradients (keyed by leaf name, as ``cuts``) the whole
    batch's, in place: a leaf the batch axes do not cut (FSDP gives the
    others theirs summed already, ``sharding.fsdp_gather``) is summed over
    those axes, in one all-reduce per set of axes; columns that other
    ranks of 'model' hold too (``Cut.shared``) are summed over their
    holders.  Nothing is summed over 'model' otherwise: the collectives'
    convention (``sharding``) makes a replicated leaf's gradient whole on
    every rank."""
    batch = [a for a in sh.batch_axes(comm.mesh) if comm.sizes[a] > 1]
    buckets: dict[tuple, list] = {}
    for n, c in cuts.items():
        if n in grads:
            axes = tuple(a for a in batch if a not in c.dp_axes)
            if axes:
                buckets.setdefault(axes, []).append(n)
    with torch.no_grad():
        for axes, names in buckets.items():
            flat = torch.cat([grads[n].float().reshape(-1) for n in names])
            flat = comm.all_reduce(flat, axes)
            for n, part in zip(names, flat.split(
                    [grads[n].numel() for n in names])):
                grads[n].copy_(part.view(grads[n].shape))
        for n, c in cuts.items():
            if c.shared is None or n not in grads:
                continue
            local, where, size, _ = c.shared
            g, d = grads[n], c.tp_dim
            li = torch.as_tensor(local, device=g.device)
            wi = torch.as_tensor(where, device=g.device)
            shape = list(g.shape)
            shape[d] = size
            buf = g.new_zeros(shape, dtype=torch.float32)
            buf.index_add_(d, wi, g.index_select(d, li).float())
            buf = comm.all_reduce(buf, c.tp_axes)
            g.index_copy_(d, li, buf.index_select(d, wi).to(g.dtype))
    return grads


def apply(grads: dict, params: nn.Module, state: OptState, cfg: AdamWConfig,
          *, gnorm: torch.Tensor | None = None
          ) -> tuple[nn.Module, OptState, dict]:
    """One AdamW update from ``grads`` (keyed like ``state.master``, any
    float dtype), in place: ``state`` advances one step and every parameter
    of ``params`` receives its updated master.  ``gnorm``: the global
    gradient norm the clip reads (a shard's, from ``global_norm`` of
    ``shard_pieces``), ``global_norm(grads)`` when None.  Returns (params,
    state, {grad_norm, lr}); no host sync (grad_norm stays on the
    device)."""
    names = list(state.master)
    with torch.no_grad():
        g = [grads[n].float() for n in names]
        if gnorm is None:
            gnorm = global_norm(g)
        scale = (cfg.grad_clip / gnorm.clamp_min(1e-9)).clamp_max(1.0)
        state.step += 1
        lr = schedule(state.step, cfg)
        f = np.float32
        b1c = float(f(1) - f(cfg.b1) ** f(state.step))
        b2c = float(f(1) - f(cfg.b2) ** f(state.step))
        master = [state.master[n] for n in names]
        m = [state.m[n] for n in names]
        v = [state.v[n] for n in names]
        g = torch._foreach_mul(g, scale)
        torch._foreach_mul_(m, cfg.b1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1 - cfg.b1))
        gg = torch._foreach_mul(g, 1 - cfg.b2)
        torch._foreach_mul_(gg, g)
        del g
        torch._foreach_mul_(v, cfg.b2)
        torch._foreach_add_(v, gg)
        del gg
        upd = torch._foreach_div(m, b1c)
        den = torch._foreach_div(v, b2c)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, cfg.eps)
        torch._foreach_div_(upd, den)
        del den
        if cfg.weight_decay:
            torch._foreach_add_(upd, torch._foreach_mul(master,
                                                        cfg.weight_decay))
        torch._foreach_mul_(upd, lr)
        torch._foreach_sub_(master, upd)
        del upd
        named = dict(params.named_parameters())
        torch._foreach_copy_([named[n] for n in names], master)
    return params, state, {"grad_norm": gnorm, "lr": lr}
