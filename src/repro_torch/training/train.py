"""Train-step factory (PyTorch port of ``repro/training/train.py``): one
device, or FSDP x TP on a (pod, data, model) mesh.

``build_train_step`` returns ``step(model, opt_state, batch) -> (model,
opt_state, metrics)``: the loss and its gradients by autograd over the
training forward (``transformer.loss_fn``, attention through
``chunked_attention``), optionally summed over microbatches, then one
AdamW update.  The reference's jitted step donates the parameter and
optimizer buffers; this one updates the model and the ``OptState`` in place
and returns the same objects.  ``param_shardings`` / ``opt_shardings`` /
``batch_shardings`` give the reference's specs as tuples; a step on a mesh
runs on the rank's shard of them (``build_train_step``).

The training loop with checkpoint/restart is ``launch/train.py``.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.distributed import sharding as sh
from repro_torch.models import quant as Q
from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig
from repro_torch.training import optimizer as opt


def value_and_grad(fn, model: nn.Module, *args, has_aux: bool = False):
    """``fn(model, *args)`` and its gradient with respect to every
    parameter of ``model``: ``(value, grads)``, grads keyed by parameter
    name (zeros for a parameter the value does not use, as JAX gives).
    ``requires_grad`` is on for this call only, so the model stays frozen
    for inference outside it.  ``value`` is detached; with ``has_aux`` it is
    ``(loss, aux)`` as ``fn`` returns it."""
    Q.refuse_quantized(model, "a training step")
    names, prms = zip(*model.named_parameters())
    with torch.enable_grad():
        for p in prms:
            p.requires_grad_(True)
        try:
            out = fn(model, *args)
            loss = out[0] if has_aux else out
            grads = torch.autograd.grad(loss, prms, allow_unused=True,
                                        materialize_grads=True)
        finally:
            for p in prms:
                p.requires_grad_(False)
    value = (loss.detach(), out[1]) if has_aux else loss.detach()
    return value, dict(zip(names, grads))


def param_shardings(cfg: ModelConfig, mesh, rules=None) -> dict:
    """{parameter name: its spec} under ``rules`` (``DEFAULT_RULES`` when
    None): the reference's ``param_shardings`` as the port's spec tuples
    (``sharding.tree_specs``).  ``mesh`` is a ``DeviceMesh`` or anything
    whose ``shape`` maps axis names to sizes.  A rank's shard
    (``transformer.shard_params``) holds these slices, but for an SSD
    layer's in_proj and conv, which it cuts by heads segment by segment."""
    rules = rules or sh.DEFAULT_RULES
    model = T.Transformer(cfg, device="meta")
    shapes = {n: p.shape for n, p in model.named_parameters()}
    return sh.tree_specs(shapes, T.param_axes(model), mesh,
                         rules.param_rules)


def opt_shardings(cfg: ModelConfig, mesh, rules=None) -> opt.OptState:
    """The optimizer state's specs (ZeRO: the master and both moments cut
    as the parameters are; the step whole)."""
    ps = param_shardings(cfg, mesh, rules)
    return opt.OptState(step=(), master=ps, m=ps, v=ps)


def batch_shardings(batch_spec: dict, mesh, rules=None) -> dict:
    """{key: spec} of a batch's arrays (anything with a ``shape``): rows
    over the batch axes (``act_batch``)."""
    rules = rules or sh.DEFAULT_RULES
    return {k: sh.spec_for(x.shape, ["act_batch"] + [None] * (
        len(x.shape) - 1), mesh, rules.act_rules)
        for k, x in batch_spec.items()}


def _shard_of(model: nn.Module, mesh, rules) -> None:
    """Raise unless ``model`` is a shard ``shard_params`` cut on ``mesh``
    under ``rules``."""
    if getattr(model, "comm", None) is None or model.comm.mesh is not mesh:
        raise ValueError("a step on a mesh takes the rank's shard: "
                         "transformer.shard_params(model, cfg, mesh, comm, "
                         "rules)")
    if model.rules != rules:
        raise ValueError("the shard was cut under other rules than the "
                         "step's")


def _microbatches(batch: dict, comm: sh.Comm, microbatches: int) -> dict:
    """{key: (microbatches, rows, ...)}: the rank's share of each of the
    whole batch's microbatches.  Microbatch i is the whole batch's rows
    [i B / mb, (i + 1) B / mb), as on one device, and the rank of shard r
    over the batch axes takes its r-th contiguous part of it; the rank holds
    rows [r B / n, (r + 1) B / n) (``device_put_batch``), so the batch is
    gathered over the batch axes first (token ids: a few KB).  A microbatch
    made of each rank's own i-th slice instead would hold other rows than
    one device's, with another token count and so another loss."""
    axes = sh.batch_axes(comm.mesh)
    r, n = sh.shard_index(axes, comm.mesh)
    out = {}
    for k, x in batch.items():
        rows = x.shape[0] * n
        if rows % (microbatches * n):
            raise ValueError(f"{k}: {rows} rows do not split into "
                             f"{microbatches} microbatches over {n} batch "
                             f"shards")
        whole = comm.all_gather(x, axes, 0)
        out[k] = whole.reshape((microbatches, n, -1)
                               + tuple(x.shape[1:]))[:, r]
    return out


def build_train_step(cfg: ModelConfig, ocfg: opt.AdamWConfig, mesh=None, *,
                     rules=None, microbatches: int = 1, moe_groups: int = 1):
    """The training step.  With ``microbatches`` > 1 the batch splits along
    its first dim; gradients are summed in f32 over the microbatches and
    divided by their number, the loss and metrics are their means.  On a
    mesh each rank runs its share of the whole batch's microbatch i
    (``_microbatches``), so the microbatches are one device's.
    ``moe_groups`` is the MoE layers' dispatch group count over the whole
    batch (the reference passes its data shards; 1 on one device).

    On a ``mesh`` the step takes the rank's shard
    (``transformer.shard_params(model, cfg, mesh, comm, rules)``, ``rules``
    ``DEFAULT_RULES`` when None: FSDP over the batch axes and tensor
    parallelism over 'model'), its ``OptState`` (``optimizer.init`` of the
    shard) and its rows of the batch (``data.pipeline.device_put_batch``),
    and updates them in place: the gradients of the shard's leaves by
    autograd through the mesh collectives (``sharding``), summed where the
    batch axes left them partial (``optimizer.sync_grads``), clipped by the
    norm of the whole gradient, then the AdamW update of the rank's slices.
    The loss and metrics are the whole batch's, the same on every rank.
    On a (1, 1) mesh nothing crosses the mesh and the step is one device's,
    bit for bit."""
    if mesh is not None:
        sh.check_mesh(mesh)
        rules = rules or sh.DEFAULT_RULES

    def grads_of(model, batch):
        mcfg = model.cfg if mesh is not None else cfg

        def loss_fn(m, b):
            return T.loss_fn(m, mcfg, b, moe_groups=moe_groups)

        if microbatches == 1:
            return value_and_grad(loss_fn, model, batch, has_aux=True)
        split = (_microbatches(batch, model.comm, microbatches)
                 if mesh is not None else
                 {k: x.reshape((microbatches, -1) + tuple(x.shape[1:]))
                  for k, x in batch.items()})
        grads, loss, per = None, 0.0, []
        for i in range(microbatches):
            (l, m), g = value_and_grad(
                loss_fn, model, {k: x[i] for k, x in split.items()},
                has_aux=True)
            if grads is None:
                grads = {n: torch.zeros(t.shape, dtype=torch.float32,
                                        device=t.device)
                         for n, t in g.items()}
            torch._foreach_add_(list(grads.values()), list(g.values()))
            loss = loss + l
            per.append(m)
        torch._foreach_div_(list(grads.values()), microbatches)
        loss = loss / microbatches
        metrics = {k: torch.stack([m[k] for m in per]).mean()
                   for k in per[0]}
        return (loss, metrics), grads

    def step(model, opt_state, batch):
        gnorm = None
        if mesh is not None:
            _shard_of(model, mesh, rules)
        (loss, metrics), grads = grads_of(model, batch)
        if mesh is not None:
            comm = model.comm
            opt.sync_grads(grads, model.cuts, comm)
            pieces, once = opt.shard_pieces(
                {n: grads[n] for n in opt_state.master}, model.cuts, comm)
            gnorm = opt.global_norm(pieces, once, comm)
            loss = comm.all_reduce(loss, sh.batch_axes(mesh))
        model, opt_state, om = opt.apply(grads, model, opt_state, ocfg,
                                         gnorm=gnorm)
        return model, opt_state, dict(metrics, **om, loss=loss)

    return step


def build_eval_step(cfg: ModelConfig, mesh=None, rules=None,
                    moe_groups: int = 1):
    """``step(model, batch) -> metrics`` of ``transformer.loss_fn``, no
    gradient; ``moe_groups`` as in ``build_train_step``.  On a ``mesh`` it
    takes the rank's shard and rows, as the train step does, and returns
    the whole batch's metrics."""
    if mesh is not None:
        sh.check_mesh(mesh)
        rules = rules or sh.DEFAULT_RULES

    def step(model, batch):
        if mesh is not None:
            _shard_of(model, mesh, rules)
        with torch.no_grad():
            _, metrics = T.loss_fn(model, model.cfg if mesh is not None
                                   else cfg, batch, moe_groups=moe_groups)
        return metrics

    return step
