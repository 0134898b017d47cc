"""Architecture registry of the port: every architecture of the reference's
``configs.ARCH_IDS`` — the four dense GQA gateway tiers and
``command-r-plus-104b``, the two recurrent families (the RG-LRU hybrid and
the pure SSD model), the two MoE families (fine-grained top-6 + shared,
top-1 + shared) and the two frontend backbones (``llava-next``'s vision
patches ahead of its text, ``hubert``'s audio frames into a bidirectional
encoder).

``get_config`` gives the published widths, ``get_smoke`` the small
configuration the tests run.  Arch ids take dashes or underscores.
``SHAPES``, ``applicability`` and ``cells`` are the reference's assigned
(arch, input shape) matrix.
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.common import ModelConfig

ARCH_IDS = (
    "smollm-135m",       # probe and edge tier
    "swarm-edge-1b",     # edge peer
    "qwen1.5-110b",      # edge peer (QKV bias)
    "llama3-8b",         # cloud tier (untied head)
    "recurrentgemma-2b",  # RG-LRU + local attention hybrid
    "mamba2-780m",       # attention-free SSD
    "deepseek-moe-16b",  # 64 experts top-6 + 2 shared, first layer dense
    "llama4-scout-17b-a16e",  # 16 experts top-1 + 1 shared, every layer
    "command-r-plus-104b",  # dense GQA, G=12, vocab 256000
    "llava-next-mistral-7b",  # vision patches + text, Mistral backbone
    "hubert-xlarge",     # audio frames, bidirectional gelu encoder
)


def _modname(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def _module(arch: str):
    name = _modname(arch)
    if name not in {_modname(a) for a in ARCH_IDS}:
        raise ValueError(f"unknown arch {arch!r}; the port serves {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_smoke(arch: str) -> ModelConfig:
    return _module(arch).smoke()


# ---------------------------------------------------------------------------
# Assigned input shapes (LM family: seq_len x global_batch), the reference's
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str        # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

# the reference's matrix rows, in its order: its ARCH_IDS less the swarm
# prototype's own tier
CELL_ARCHS = (
    "hubert-xlarge",
    "qwen1.5-110b",
    "smollm-135m",
    "llama3-8b",
    "command-r-plus-104b",
    "mamba2-780m",
    "recurrentgemma-2b",
    "llama4-scout-17b-a16e",
    "deepseek-moe-16b",
    "llava-next-mistral-7b",
)


def applicability(cfg: ModelConfig, shape: ShapeSpec) -> str | None:
    """None if the (arch, shape) cell runs; else the skip reason."""
    if cfg.family in ("encoder", "audio") and shape.kind == "decode":
        return "encoder-only: no decode step"
    if shape.name == "long_500k" and not _subquadratic(cfg):
        return "full quadratic attention: long_500k needs sub-quadratic"
    return None


def _subquadratic(cfg: ModelConfig) -> bool:
    return "attn" not in {m for m, _ in cfg.layer_plan()}


def cells(include_skipped: bool = False) -> list:
    """Every (arch, shape name, skip reason) cell of the assigned matrix;
    the skipped ones only with ``include_skipped``."""
    out = []
    for arch in CELL_ARCHS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            skip = applicability(cfg, shape)
            if skip is None or include_skipped:
                out.append((arch, shape.name, skip))
    return out
