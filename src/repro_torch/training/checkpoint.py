"""Atomic checkpoints of a model and its optimizer state (PyTorch port of
``repro/training/checkpoint.py``, single process).

The reference's on-disk format: ``<dir>/step_<n>/manifest.json`` (step,
extra, a description of the tree, every leaf's shape and dtype) and
``shard_0.npz`` (one ``<path>@full`` array per leaf).  Leaf paths are the
port's: ``params/<parameter name>``, ``opt/step``, ``opt/master/<name>``,
``opt/m/<name>``, ``opt/v/<name>`` for the tree ``{"params": model, "opt":
OptState}``.  npz cannot hold bf16, so a bf16 leaf is stored as its
``uint16`` bits and the manifest records ``bfloat16``; restore decodes the
bits with torch (``view(torch.bfloat16)``), so no numpy bf16 type is
needed.

A save writes ``<dir>/tmp_<n>``, publishes it with ``os.replace`` and only
then rewrites ``LATEST``, so a crash mid-save never damages the state a
restart recovers; the newest ``keep`` checkpoints are kept.  ``restore``
fills the tensors of a live tree in place.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any

import numpy as np
import torch
from torch import nn

from repro_torch.models import quant as Q
from repro_torch.training.optimizer import OptState

SEP = "/"


def _children(tree: Any) -> dict | None:
    """A node's children by name, or None for a leaf."""
    if isinstance(tree, nn.Module):
        Q.refuse_quantized(tree, "a checkpoint")
        return dict(tree.named_parameters())
    if isinstance(tree, OptState):
        return {f.name: getattr(tree, f.name)
                for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        return tree
    return None


def _flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    kids = _children(tree)
    if kids is None:
        return {prefix.rstrip(SEP): tree}
    out = {}
    for k, v in kids.items():
        out.update(_flatten(v, f"{prefix}{k}{SEP}"))
    return out


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(array npz can hold, logical dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
        return a, str(a.dtype)
    a = np.asarray(leaf, dtype=np.int32)          # the optimizer step
    return a, str(a.dtype)


def save(ckpt_dir: str, step: int, tree: Any, extra: dict | None = None,
         keep: int = 3) -> str:
    """Write one checkpoint atomically; prune old ones.  Returns the final
    path."""
    tmp = os.path.join(ckpt_dir, f"tmp_{step}")
    final = os.path.join(ckpt_dir, f"step_{step}")
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "extra": extra or {},
                "treedef": str({k: type(v).__name__ for k, v in
                                (_children(tree) or {}).items()}),
                "leaves": {}}
    payload = {}
    for path, leaf in _flatten(tree).items():
        arr, dtype = _to_numpy(leaf)
        manifest["leaves"][path] = {"shape": list(arr.shape), "dtype": dtype}
        payload[f"{path}@full"] = arr
    np.savez(os.path.join(tmp, "shard_0.npz"), **payload)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)                       # atomic publish
    with open(os.path.join(ckpt_dir, "LATEST.tmp"), "w") as f:
        f.write(str(step))
    os.replace(os.path.join(ckpt_dir, "LATEST.tmp"),
               os.path.join(ckpt_dir, "LATEST"))
    _prune(ckpt_dir, keep)
    return final


def _prune(ckpt_dir: str, keep: int):
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                   if d.startswith("step_"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)


def latest_step(ckpt_dir: str) -> int | None:
    path = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return int(f.read().strip())


def read_extra(ckpt_dir: str, step: int) -> dict:
    """The ``extra`` dict checkpoint ``step`` was saved with."""
    with open(os.path.join(ckpt_dir, f"step_{step}", "manifest.json")) as f:
        return json.load(f)["extra"]


def load_leaves(ckpt_dir: str, step: int) -> tuple[dict, dict]:
    """({path: CPU tensor, or int for a 0-d integer leaf}, extra) of one
    checkpoint, each leaf in its logical dtype."""
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    out = {}
    with np.load(os.path.join(d, "shard_0.npz")) as z:
        for path, meta in manifest["leaves"].items():
            a = z[f"{path}@full"].reshape(meta["shape"])
            if meta["dtype"] == "bfloat16":
                out[path] = torch.from_numpy(a.view(np.uint16)).view(
                    torch.bfloat16)
            elif a.ndim == 0 and a.dtype.kind in "iu":
                out[path] = int(a)
            else:
                out[path] = torch.from_numpy(np.ascontiguousarray(a))
    return out, manifest["extra"]


def restore(ckpt_dir: str, step: int, like: Any) -> tuple[Any, dict]:
    """Fill the live tree ``like`` (the structure ``save`` was given, e.g.
    ``{"params": model, "opt": OptState}``) from checkpoint ``step``, in
    place: every tensor is copied into (its device and dtype kept, which
    must match the manifest's), integer leaves are set.  Returns (like,
    extra)."""
    leaves, extra = load_leaves(ckpt_dir, step)
    live = _flatten(like)
    if set(live) != set(leaves):
        raise ValueError(f"checkpoint step {step} holds other leaves than the "
                         f"tree: missing {sorted(set(live) - set(leaves))[:5]}"
                         f", extra {sorted(set(leaves) - set(live))[:5]}")
    with torch.no_grad():
        for path, val in leaves.items():
            cur = live[path]
            if isinstance(cur, torch.Tensor):
                if cur.shape != val.shape or cur.dtype != val.dtype:
                    raise ValueError(f"{path}: checkpoint {val.dtype} "
                                     f"{tuple(val.shape)}, tree {cur.dtype} "
                                     f"{tuple(cur.shape)}")
                cur.copy_(val)
            else:
                *parents, name = path.split(SEP)
                node = like
                for p in parents:
                    node = _children(node)[p]
                if isinstance(node, dict):
                    node[name] = val
                else:
                    setattr(node, name, val)
    return like, extra
