"""Deterministic, restart-safe data pipeline (PyTorch port of
``repro/data/pipeline.py``, single device).

Batches are pure functions of (seed, step): resuming from a checkpoint at
step N replays exactly the stream an uninterrupted run would have seen,
with no state file to lose.  ``device_put_batch`` moves a host batch onto
one device; the reference's mesh placement waits for mesh-sharded
training.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.data.workload import FactWorld


@dataclasses.dataclass
class SyntheticLMPipeline:
    """Fact-world LM stream (``data/workload.py``) + filler diversity."""
    batch: int
    seq: int
    two_hop: bool = False
    seed: int = 7
    world: FactWorld | None = None

    def __post_init__(self):
        self.world = self.world or FactWorld()

    def get_batch(self, step: int) -> dict[str, np.ndarray]:
        return self.world.training_batch(self.batch, self.seq, step,
                                         two_hop=self.two_hop, seed=self.seed)


def device_put_batch(batch: dict[str, np.ndarray], device) -> dict:
    """Every array of ``batch`` as a tensor on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
