"""Convert a JAX parameter tree (as numpy arrays) into the port's model.

The JAX package stacks the layers of a scanned stage along a leading repeat
axis (``repro/models/transformer.py::model_defs``); the port keeps one
module per layer, so conversion unstacks that axis and copies every leaf in
its own layout.  bf16 leaves go through ``astype(np.float32)``, which is
exact, then ``.to(torch.bfloat16)``, which is exact again.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import Transformer


def _tensor(a, dtype) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.float32)).to(dtype)


def from_jax_params(np_tree: dict, cfg: ModelConfig,
                    device=None) -> Transformer:
    """``np_tree``: the JAX ``init_params`` tree with numpy leaves
    (``jax.tree.map(np.asarray, params)``).  Returns the port's model on
    ``device`` (default CPU)."""
    model = Transformer(cfg)
    with torch.no_grad():
        model.embed.copy_(_tensor(np_tree["embed"], cfg.dtype))
        model.final_norm.copy_(_tensor(np_tree["final_norm"], cfg.dtype))
        if not cfg.tie_embeddings:
            model.lm_head.copy_(_tensor(np_tree["lm_head"], cfg.dtype))
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
