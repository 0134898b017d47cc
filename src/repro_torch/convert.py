"""Convert a JAX parameter tree (as numpy arrays) into the port's model.

The JAX package stacks the layers of a scanned stage along a leading repeat
axis (``repro/models/transformer.py::model_defs``); the port keeps one
module per layer, so conversion unstacks that axis and copies every leaf in
its own layout.  bf16 leaves go through ``astype(np.float32)``, which is
exact, then ``.to(torch.bfloat16)``, which is exact again.  The safety
classifier's tree (``init_safety``: ``head_w``/``head_b`` and no
``lm_head``) converts into the port's ``SafetyClassifier``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.safety import SafetyClassifier
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
