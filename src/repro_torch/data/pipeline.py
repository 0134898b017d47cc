"""Deterministic, restart-safe data pipeline (PyTorch port of
``repro/data/pipeline.py``).

Batches are pure functions of (seed, step): resuming from a checkpoint at
step N replays exactly the stream an uninterrupted run would have seen,
with no state file to lose.  ``device_put_batch`` moves a host batch onto
one device, or hands a mesh rank its rows.
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


def batch_sharding(mesh) -> tuple:
    """The spec of a batch's arrays: rows over the batch axes present in
    ``mesh`` (major to minor), the reference's ``P(("pod", "data"))``."""
    names = getattr(mesh, "mesh_dim_names", None) or tuple(mesh.shape)
    axes = tuple(a for a in ("pod", "data") if a in names)
    return (axes if len(axes) > 1 else axes[0],) if axes else ()


def device_put_batch(batch: dict[str, np.ndarray], where,
                     device=None) -> dict:
    """Every array of ``batch`` as a tensor on a device.  ``where`` a
    device: the whole arrays there.  ``where`` a ``DeviceMesh``: this
    rank's rows (``batch_sharding``: the rank's contiguous shard of the
    first dim over the batch axes), on ``device`` (the mesh's device type
    when None); a first dim the batch axes do not divide raises
    ``ValueError``, as the reference's ``make_array_from_callback``
    does."""
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(where, DeviceMesh):
        return {k: torch.as_tensor(v, device=where) for k, v in batch.items()}
    from repro_torch.distributed import sharding as sh
    spec = batch_sharding(where)
    r, n = sh.shard_index(spec[0] if spec else None, where)
    out = {}
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"{k}: {v.shape[0]} rows over {n} batch shards")
        b = v.shape[0] // n
        out[k] = torch.as_tensor(np.ascontiguousarray(v[r * b:(r + 1) * b]),
                                 device=device or where.device_type)
    return out
