"""Device meshes (PyTorch port of ``repro/launch/mesh.py``).

The builders are FUNCTIONS: importing this module touches no process
group.  A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the
ranks of the default process group, with named axes:

  pod   — failure/locality domain (the paper's "edge site")
  data  — FSDP / batch parallelism
  model — tensor parallelism

The ranks play the reference's devices: ``len(jax.devices())`` becomes the
world size.  When no process group is up, a builder starts one: under
``torchrun`` (``WORLD_SIZE`` in the environment) from the environment,
otherwise a world of one over a ``dist.HashStore()`` (no socket) — NCCL on
the card, gloo when the caller passes ``device="cpu"``.  Ranks that a
caller spawned and joined itself are used as they are.
"""

from __future__ import annotations

import math
import os

import torch.distributed as dist

from repro_torch.distributed.sharding import axis_sizes
from repro_torch.models.common import resolve_device


def ensure_world(device=None) -> int:
    """The world size of the default process group, started first when
    none is up (module docstring); ``device`` picks its backend then."""
    if not dist.is_initialized():
        dev = resolve_device(device, "a device mesh")
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            dist.init_process_group(backend)            # env:// (torchrun)
        else:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
    return dist.get_world_size()


def _device_mesh(shape: tuple[int, ...], names: tuple[str, ...]):
    """A ``DeviceMesh`` of ``shape`` over the whole world."""
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size()
    if math.prod(shape) != n:
        raise ValueError(f"a {dict(zip(names, shape))} mesh needs "
                         f"{math.prod(shape)} ranks, the world has {n}")
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(kind, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The (16, 16) (data, model) mesh, or (2, 16, 16) (pod, data, model)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    ensure_world(device)
    return _device_mesh(shape, axes)


def elastic_shape(n: int, model_parallel: int = 16, pods: int = 1
                  ) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """``elastic_mesh``'s (shape, axis names) over ``n`` ranks."""
    model_parallel = min(model_parallel, n)
    while n % model_parallel:
        model_parallel //= 2
    rest = n // model_parallel
    pods = min(pods, rest)
    while rest % pods:
        pods -= 1
    data = rest // pods
    if pods > 1:
        return (pods, data, model_parallel), ("pod", "data", "model")
    return (data, model_parallel), ("data", "model")


def elastic_mesh(model_parallel: int = 16, pods: int = 1, device=None):
    """The largest (pod, data, model) mesh the live ranks support —
    restore-time elasticity: a checkpoint re-shards onto whatever is
    alive."""
    return _device_mesh(*elastic_shape(ensure_world(device), model_parallel,
                                       pods))


def serving_shape(n: int, model_parallel: int = 1
                  ) -> tuple[tuple[int, int], tuple[str, str]]:
    """``serving_mesh``'s (shape, axis names) over ``n`` ranks."""
    model_parallel = max(1, min(model_parallel, n))
    while n % model_parallel:
        model_parallel -= 1
    return (n // model_parallel, model_parallel), ("data", "model")


def serving_mesh(model_parallel: int = 1, device=None):
    """(data, model) mesh over the live ranks for the serving runtime.

    ``model_parallel`` is clamped down to the nearest divisor of the rank
    count; the remaining ranks become the 'data' axis (decode slots /
    request batch).  With one rank this is the degenerate (1, 1) mesh: the
    sharded engine code path with single-device placement."""
    return _device_mesh(*serving_shape(ensure_world(device), model_parallel))


def data_shards(mesh) -> int:
    """Number of batch shards = product of the pod/data axis sizes."""
    sizes = axis_sizes(mesh)
    n = 1
    for a in ("pod", "data"):
        n *= sizes.get(a, 1)
    return n
