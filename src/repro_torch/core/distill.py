"""Distillation feedback loop (paper Sec. IV-H): the buffer, PyTorch.

Mirrors ``repro/core/distill.py::DistillBuffer``: when D(Q) = cloud, the
gateway logs (Q, M_cloud(Q)) into a privacy-scrubbed ring buffer that
later fine-tunes edge adapters.  The LoRA distillation step
(``distill_loss``, ``distill_step``) waits for the training slice.
"""

from __future__ import annotations

import dataclasses


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
