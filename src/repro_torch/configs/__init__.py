"""Architecture registry of the port: the four dense GQA gateway tiers, the
two recurrent families (the RG-LRU hybrid and the pure SSD model) and the
two MoE families (fine-grained top-6 + shared, top-1 + shared).

``get_config`` gives the published widths, ``get_smoke`` the small
configuration the tests run.  Arch ids take dashes or underscores.
"""

from __future__ import annotations

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
