"""Distillation feedback loop (paper Sec. IV-H), PyTorch port of
``repro/core/distill.py``.

When D(Q) = cloud, the gateway logs (Q, M_cloud(Q)) into a
privacy-scrubbed ring buffer (``DistillBuffer``); logged examples later
fine-tune edge LoRA adapters against the cloud teacher: soft-target KL at a
temperature plus hard-target CE (``distill_loss``), one plain-SGD step on
the adapters only (``distill_step``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import lora as lora_lib
from repro_torch.models.common import ModelConfig


@dataclasses.dataclass
class DistillBuffer:
    """Host-side ring buffer of escalated queries + teacher responses."""
    capacity: int = 4096
    items: list = dataclasses.field(default_factory=list)

    def log(self, query_tokens, teacher_tokens, meta: dict | None = None,
            scrub=None):
        """Respecting privacy policy: ``scrub`` strips/anonymises before
        storage."""
        if scrub is not None:
            query_tokens, teacher_tokens = scrub(query_tokens, teacher_tokens)
        self.items.append({"query": query_tokens, "teacher": teacher_tokens,
                           "meta": meta or {}})
        if len(self.items) > self.capacity:
            self.items.pop(0)

    def sample(self, rng, batch: int):
        idx = rng.choice(len(self.items), size=min(batch, len(self.items)),
                         replace=False)
        return [self.items[i] for i in idx]


def distill_loss(lora_params: dict, base_params, cfg: ModelConfig,
                 batch: dict, teacher_logits: torch.Tensor, *,
                 kl_weight: float = 0.5,
                 temperature: float = 2.0) -> torch.Tensor:
    """KL(teacher || student) at ``temperature`` (its student cross-entropy
    part, as the reference) + hard-target CE, masked by ``loss_mask``; the
    student is ``base_params`` with the adapters merged, run through the
    training forward (autograd reaches the adapters only)."""
    params = lora_lib.merge(base_params, lora_params)
    logits, _ = torch.func.functional_call(base_params, params, (batch,),
                                           {"train": True})
    lf = logits.float()
    sl = torch.log_softmax(lf / temperature, -1)
    tl = torch.softmax(teacher_logits.float() / temperature, -1)
    kl = -(tl * sl).sum(-1)
    ce = -torch.log_softmax(lf, -1).gather(
        -1, batch["labels"].long()[..., None])[..., 0]
    per = kl_weight * kl * temperature ** 2 + (1 - kl_weight) * ce
    mask = batch.get("loss_mask")
    if mask is not None:
        return (per * mask).sum() / mask.sum().clamp_min(1.0)
    return per.mean()


def distill_step(lora_params: dict, base_params, cfg: ModelConfig,
                 batch: dict, teacher_logits: torch.Tensor,
                 lr: float = 1e-3) -> tuple[dict, torch.Tensor]:
    """One plain-SGD step on the adapters: a new adapter tree a - lr *
    grad(a) (the input tree is left as it was).  Returns (adapters,
    loss)."""
    leaves = [(n, k, t) for n, ab in lora_params.items()
              for k, t in ab.items()]
    with torch.enable_grad():
        live = {n: {} for n in lora_params}
        for n, k, t in leaves:
            live[n][k] = t.detach().requires_grad_(True)
        loss = distill_loss(live, base_params, cfg, batch, teacher_logits)
        grads = torch.autograd.grad(loss, [live[n][k] for n, k, _ in leaves])
    out = {n: {} for n in lora_params}
    with torch.no_grad():
        for (n, k, t), g in zip(leaves, grads):
            out[n][k] = t - lr * g
    return out, loss.detach()
