"""Convert a JAX parameter tree (as numpy arrays) into the port's model.

The JAX package stacks the layers of a scanned stage along a leading repeat
axis (``repro/models/transformer.py::model_defs``); the port keeps one
module per layer, so conversion unstacks that axis and copies every leaf in
its own layout and dtype (the recurrences' f32 leaves, ``lam``, ``A_log``,
``dt_bias`` and ``D_skip``, stay f32 in a bf16 model).  bf16 leaves go
through ``astype(np.float32)``, which is exact, then
``.to(torch.bfloat16)``, which is exact again.  The safety
classifier's tree (``init_safety``: ``head_w``/``head_b`` and no
``lm_head``) converts into the port's ``SafetyClassifier``.

``from_jax_paged_pool`` converts a JAX block pool (``CachePool.arrays``)
into the port's per-layer pools (KV blocks and recurrent state rows),
byte for byte, so tests can compare the two after the same calls.  ``from_jax_opt_state`` carries an AdamW state
across (master, m and v through the same mapping as the parameters, in
f32; the step as an int), ``from_jax_lora`` a LoRA adapter tree.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.safety import SafetyClassifier
from repro_torch.models import attention, rglru, ssm
from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import Transformer
from repro_torch.training.optimizer import OptState


def _tensor(a, dtype) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.float32)).to(dtype)


def _layer_blocks(stages, cfg: ModelConfig):
    """(port layer index, the JAX block subtree, repeat index or None) of
    every layer, unstacking the scanned stages; ``stages`` is a list, or a
    dict keyed "0", "1", ... (a LoRA tree)."""
    if isinstance(stages, dict):
        stages = [stages.get(str(i), {}) for i in range(len(stages))]
    layer = 0
    for sp, stage in zip(stages, cfg.stage_plan()):
        for r in range(stage.repeat):
            for i in range(len(stage.blocks)):
                yield layer, sp.get(f"b{i}", {}), (
                    r if stage.repeat > 1 else None)
                layer += 1


def _walk(prefix: str, tree: dict):
    """(dotted name, leaf) of a nested dict: an MoE's ``shared`` expert is a
    dict inside the ``ffn`` subtree."""
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            yield from _walk(f"{prefix}.{name}", leaf)
        else:
            yield f"{prefix}.{name}", leaf


def _named_leaves(np_tree: dict, cfg: ModelConfig):
    """(port parameter name, numpy leaf) of a JAX ``init_params`` /
    ``init_safety`` tree, repeat axes unstacked (only those: an MoE's
    (E, ...) expert stacks keep their layout)."""
    safety = "head_w" in np_tree
    top = ["embed", "final_norm"]
    top += ["head_w", "head_b"] if safety else (
        [] if cfg.tie_embeddings else ["lm_head"])
    for name in top:
        yield name, np.asarray(np_tree[name])
    n = 0
    for layer, blk, r in _layer_blocks(np_tree["stages"], cfg):
        for part in ("mixer", "ffn"):
            for name, leaf in _walk(f"layers.{layer}.{part}",
                                    blk.get(part, {})):
                a = np.asarray(leaf)
                yield name, a if r is None else a[r]
        n = layer + 1
    if n != cfg.num_layers:
        raise ValueError(f"JAX tree has {n} layers, cfg {cfg.num_layers}")


def from_jax_params(np_tree: dict, cfg: ModelConfig,
                    device=None) -> Transformer:
    """``np_tree``: the JAX ``init_params`` (or ``init_safety``) tree with
    numpy leaves (``jax.tree.map(np.asarray, params)``).  Returns the port's
    ``Transformer`` (or ``SafetyClassifier``) on ``device`` (default
    CPU)."""
    model = (SafetyClassifier(cfg) if "head_w" in np_tree
             else Transformer(cfg))
    named = dict(model.named_parameters())
    with torch.no_grad():
        for name, a in _named_leaves(np_tree, cfg):
            named[name].copy_(_tensor(a, named[name].dtype))
    return model.to(device) if device is not None else model


def from_jax_opt_state(np_state, cfg: ModelConfig, device=None) -> OptState:
    """``np_state``: a JAX ``optimizer.OptState`` with numpy leaves.
    Returns the port's ``OptState``: master, m and v in f32 under the
    parameter names ``from_jax_params`` gives, the step as an int."""
    def conv(tree):
        return {n: torch.from_numpy(np.array(a, np.float32)).to(device)
                for n, a in _named_leaves(tree, cfg)}
    return OptState(step=int(np.asarray(np_state.step)),
                    master=conv(np_state.master), m=conv(np_state.m),
                    v=conv(np_state.v))


def from_jax_lora(np_tree: dict, cfg: ModelConfig, device=None) -> dict:
    """``np_tree``: a JAX ``lora.init_lora`` tree with numpy leaves.
    Returns the port's adapter tree {parameter name: {"a", "b"}} (f32
    tensors, repeat axes unstacked)."""
    out = {}
    for layer, blk, r in _layer_blocks(np_tree.get("stages", {}), cfg):
        for part, sub in blk.items():
            for name, ab in sub.items():
                out[f"layers.{layer}.{part}.{name}"] = {
                    k: torch.from_numpy(np.array(
                        a if r is None else a[r], np.float32)).to(device)
                    for k, a in ab.items()}
    return out


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
    leaves as a uint8 view).  Returns one pool per layer in the port's
    layout: an ``attention.KVPool`` with the sink block (zeros, pos -1), or
    an ``RGLRUState`` / ``SSMState`` of rows with the sink row (zeros), on
    ``device`` (default CPU)."""
    out = []
    for sc, stage in zip(np_layers, cfg.stage_plan()):
        for r in range(stage.repeat):
            for i in range(len(stage.blocks)):
                lc = sc[f"b{i}"]
                if lc.kv is None:
                    st = lc.rg if lc.rg is not None else lc.ssd
                    kind = (rglru.RGLRUState if lc.rg is not None
                            else ssm.SSMState)
                    leaves = [np.asarray(a) for a in st]
                    if stage.repeat > 1:
                        leaves = [a[r] for a in leaves]
                    dts = (torch.float32, cfg.dtype)
                    out.append(kind(*(_pool_leaf(a, d, 0)
                                      for a, d in zip(leaves, dts))))
                    continue
                kv = [None if a is None else np.asarray(a)
                      for a in lc.kv]
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
    return [type(p)(*(None if t is None else t.to(device) for t in p))
            for p in out]
