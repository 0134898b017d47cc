"""Convert a JAX parameter tree (as numpy arrays) into the port's model.

The JAX package stacks the layers of a scanned stage along a leading repeat
axis (``repro/models/transformer.py::model_defs``); the port keeps one
module per layer, so conversion unstacks that axis and copies every leaf in
its own layout.  bf16 leaves go through ``astype(np.float32)``, which is
exact, then ``.to(torch.bfloat16)``, which is exact again.  The safety
classifier's tree (``init_safety``: ``head_w``/``head_b`` and no
``lm_head``) converts into the port's ``SafetyClassifier``.

``from_jax_paged_pool`` converts a JAX block pool (``CachePool.arrays``)
into the port's per-layer pools, byte for byte, so tests can compare the
two after the same calls.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.safety import SafetyClassifier
from repro_torch.models import attention
from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import Transformer


def _tensor(a, dtype) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.float32)).to(dtype)


def from_jax_params(np_tree: dict, cfg: ModelConfig,
                    device=None) -> Transformer:
    """``np_tree``: the JAX ``init_params`` (or ``init_safety``) tree with
    numpy leaves (``jax.tree.map(np.asarray, params)``).  Returns the port's
    ``Transformer`` (or ``SafetyClassifier``) on ``device`` (default
    CPU)."""
    safety = "head_w" in np_tree
    model = SafetyClassifier(cfg) if safety else Transformer(cfg)
    top = ["embed", "final_norm"]
    top += ["head_w", "head_b"] if safety else (
        [] if cfg.tie_embeddings else ["lm_head"])
    with torch.no_grad():
        for name in top:
            getattr(model, name).copy_(_tensor(np_tree[name], cfg.dtype))
        layers = iter(model.layers)
        for sp, stage in zip(np_tree["stages"], cfg.stage_plan()):
            for r in range(stage.repeat):
                for i in range(len(stage.blocks)):
                    layer = next(layers)
                    for part in ("mixer", "ffn"):
                        mod = getattr(layer, part)
                        for name, leaf in sp[f"b{i}"][part].items():
                            a = np.asarray(leaf)
                            if stage.repeat > 1:
                                a = a[r]
                            getattr(mod, name).copy_(_tensor(a, cfg.dtype))
        if next(layers, None) is not None:
            raise ValueError("JAX tree has fewer layers than cfg.num_layers")
    return model.to(device) if device is not None else model


def _pool_leaf(a: np.ndarray, dtype, fill) -> torch.Tensor:
    """One JAX pool leaf (N, ...) in ``dtype``, with the sink block
    appended.  int8 and fp8 (a uint8 view: numpy has no fp8) cross as
    bytes; the rest through f32, which is exact for bf16, int32 positions
    and f32 scales."""
    if a.dtype in (np.uint8, np.int8):
        t = torch.from_numpy(a.view(np.uint8).copy()).view(dtype)
    else:
        t = torch.from_numpy(a.astype(np.float32)).to(dtype)
    sink = torch.full((1, *t.shape[1:]), fill, dtype=torch.float32)
    return torch.cat([attention.raw(t),
                      attention.raw(sink.to(dtype))]).view(dtype)


def from_jax_paged_pool(np_layers: list, cfg: ModelConfig,
                        device=None) -> list:
    """``np_layers``: the JAX ``CachePool.arrays`` with numpy leaves (per
    stage a dict of ``LayerCache``, a stacked stage's leaves carrying a
    leading repeat axis, unstacked here as ``from_jax_params`` does; fp8
    leaves as a uint8 view).  Returns one ``attention.KVPool`` per layer
    in the port's layout, sink block included (zeros, pos -1), on
    ``device`` (default CPU)."""
    out = []
    for sc, stage in zip(np_layers, cfg.stage_plan()):
        for r in range(stage.repeat):
            for i in range(len(stage.blocks)):
                kv = [None if a is None else np.asarray(a)
                      for a in sc[f"b{i}"].kv]
                if stage.repeat > 1:
                    kv = [None if a is None else a[r] for a in kv]
                k, v, pos, ks, vs = kv
                dt = {np.dtype(np.uint8): torch.float8_e4m3fn,
                      np.dtype(np.int8): torch.int8}.get(k.dtype, cfg.dtype)
                out.append(attention.KVPool(
                    *(None if a is None else _pool_leaf(a, d, f)
                      for a, d, f in ((k, dt, 0), (v, dt, 0),
                                      (pos, torch.int32, -1),
                                      (ks, torch.float32, 0),
                                      (vs, torch.float32, 0)))))
    if len(out) != cfg.num_layers:
        raise ValueError(f"JAX pool has {len(out)} layers, cfg "
                         f"{cfg.num_layers}")
    if device is None:
        return out
    return [attention.KVPool(*(None if t is None else t.to(device)
                               for t in p)) for p in out]
