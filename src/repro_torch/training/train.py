"""Train-step factory (PyTorch port of ``repro/training/train.py``),
single device.

``build_train_step`` returns ``step(model, opt_state, batch) -> (model,
opt_state, metrics)``: the loss and its gradients by autograd over the
training forward (``transformer.loss_fn``, attention through
``chunked_attention``), optionally summed over microbatches, then one
AdamW update.  The reference's jitted step donates the parameter and
optimizer buffers; this one updates the model and the ``OptState`` in place
and returns the same objects.  Mesh-sharded training (the reference's
``param_shardings``/``opt_shardings``/``batch_shardings``) is not ported:
a ``mesh`` raises.

The training loop with checkpoint/restart is ``launch/train.py``.
"""

from __future__ import annotations

import torch
from torch import nn

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


def build_train_step(cfg: ModelConfig, ocfg: opt.AdamWConfig, mesh=None, *,
                     microbatches: int = 1, moe_groups: int = 1):
    """The training step.  With ``microbatches`` > 1 the batch splits along
    its first dim; gradients are summed in f32 over the microbatches and
    divided by their number, the loss and metrics are their means.
    ``moe_groups`` is the MoE layers' dispatch group count (the reference
    passes its data shards; 1 on one device)."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh-sharded training is not ported to the PyTorch package "
            "yet; train on one device (mesh=None)")

    def loss_fn(model, batch):
        return T.loss_fn(model, cfg, batch, moe_groups=moe_groups)

    def step(model, opt_state, batch):
        if microbatches == 1:
            (loss, metrics), grads = value_and_grad(
                loss_fn, model, batch, has_aux=True)
        else:
            split = {k: x.reshape((microbatches, -1) + tuple(x.shape[1:]))
                     for k, x in batch.items()}
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
        model, opt_state, om = opt.apply(grads, model, opt_state, ocfg)
        return model, opt_state, dict(metrics, **om, loss=loss)

    return step


def build_eval_step(cfg: ModelConfig, mesh=None):
    """``step(model, batch) -> metrics`` of ``transformer.loss_fn``, no
    gradient."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh-sharded evaluation is not ported to the PyTorch package "
            "yet; evaluate on one device (mesh=None)")

    def step(model, batch):
        with torch.no_grad():
            _, metrics = T.loss_fn(model, cfg, batch)
        return metrics

    return step
