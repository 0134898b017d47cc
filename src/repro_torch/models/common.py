"""Shared model substrate: config, norms, RoPE and activations (PyTorch).

Mirrors ``repro/models/common.py``.  ``ModelConfig`` keeps every field of
the JAX config so a config converts field by field, with ``torch`` dtypes in
place of ``jnp`` ones.  Parameters live in ``nn.Module``s
(``models/transformer.py``) instead of the JAX ``ParamDef`` trees.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"  # dense | moe | ssm | hybrid | encoder | vlm | audio

    num_layers: int = 2
    d_model: int = 128
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 32
    d_ff: int = 256
    vocab_size: int = 256

    # attention
    attn_bias: bool = False            # qwen-style QKV bias
    rope_theta: float = 10_000.0
    causal: bool = True                # False => bidirectional encoder
    window: int | None = None          # sliding-window size for "attn_local"
    mixer_pattern: tuple[str, ...] = ("attn",)   # cycled per layer

    # ffn
    ffn_act: str = "swiglu"            # swiglu | geglu | gelu

    # moe
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    first_k_dense: int = 0
    moe_every: int = 1
    moe_offset: int = 0
    capacity_factor: float = 1.25
    moe_serve_capacity_factor: float | None = None
    moe_decode_impl: str = "dispatch"

    # ssm (mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_ngroups: int = 1
    ssm_conv_width: int = 4
    ssm_chunk: int = 128

    # rg-lru (griffin / recurrentgemma)
    rnn_width: int = 0
    rnn_conv_width: int = 4

    # misc
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    frontend: str | None = None
    frontend_tokens: int = 0
    dtype: Any = torch.bfloat16        # parameter / KV-cache storage dtype
    compute_dtype: Any = None          # matmul operand dtype (None = dtype)
    remat: bool = True
    scan_layers: bool = True
    attn_q_block: int = 512            # bucket granularity (engine._bucket)
    attn_kv_block: int = 1024
    attn_decode_block: int = 64
    attn_prefill_impl: str | None = None
    moe_impl: str = "sort"

    # ---- derived -----------------------------------------------------
    @property
    def comp_dtype(self):
        return self.compute_dtype or self.dtype

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def num_params(self) -> int:
        """Parameter count of the model, counted on a ``Transformer`` built
        on the meta device (no memory)."""
        from repro_torch.models.transformer import Transformer
        model = Transformer(self, device="meta")
        return sum(p.numel() for p in model.parameters())

    def active_params(self) -> int:
        """Parameters a token reads: the routed experts counted top_k of
        num_experts times per MoE layer."""
        n = self.num_params()
        if self.num_experts and self.top_k:
            expert = 3 * self.d_model * self.expert_d_ff
            n_moe = sum(1 for _, f in self.layer_plan() if f == "moe")
            n -= n_moe * (self.num_experts - self.top_k) * expert
        return n

    def layer_plan(self) -> tuple[tuple[str, str], ...]:
        """Per-layer (mixer, ffn) kinds."""
        plan = []
        for i in range(self.num_layers):
            mixer = self.mixer_pattern[i % len(self.mixer_pattern)]
            if mixer == "ssd":
                ffn = "none"
            elif self.num_experts > 0 and i >= self.first_k_dense and (
                    i % self.moe_every == self.moe_offset):
                ffn = "moe"
            else:
                ffn = "mlp"
            plan.append((mixer, ffn))
        return tuple(plan)

    def stage_plan(self) -> tuple["Stage", ...]:
        """Group the layer plan into the JAX package's scanned stages.

        The port runs layers as a flat ``nn.ModuleList``; the stage plan is
        kept because the JAX parameter tree is stacked by it, so
        ``convert.from_jax_params`` needs it to unstack the repeat axis."""
        plan = list(self.layer_plan())
        if not self.scan_layers:
            return (Stage(tuple(plan), 1),)
        stages: list[Stage] = []
        for prefix in range(0, min(4, len(plan)) + 1):
            body = plan[prefix:]
            if not body:
                continue
            for period in range(1, 5):
                if len(body) % period:
                    rem = len(body) % period
                    main, tail = body[:-rem], body[-rem:]
                else:
                    main, tail = body, []
                if not main:
                    continue
                pat = main[:period]
                if all(main[i] == pat[i % period] for i in range(len(main))):
                    if prefix:
                        stages.append(Stage(tuple(plan[:prefix]), 1))
                    stages.append(Stage(tuple(pat), len(main) // period))
                    if tail:
                        stages.append(Stage(tuple(tail), 1))
                    return tuple(stages)
        return (Stage(tuple(plan), 1),)


@dataclasses.dataclass(frozen=True)
class RankConfig(ModelConfig):
    """A mesh rank's config (``transformer.shard_params``): the model's,
    with the rank's own heads, widths and SSD groups, and ``ssm_shards``,
    the ways its SSD heads are cut (``ModelConfig`` derives the SSD's
    d_inner and heads from ``d_model``, which stays whole)."""
    ssm_shards: int = 1

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model // self.ssm_shards

    @classmethod
    def of(cls, cfg: ModelConfig, **changes) -> "RankConfig":
        return cls(**{**{f.name: getattr(cfg, f.name)
                         for f in dataclasses.fields(cfg)}, **changes})


@dataclasses.dataclass(frozen=True)
class Stage:
    blocks: tuple[tuple[str, str], ...]   # ((mixer, ffn), ...)
    repeat: int


def frozen_zeros(*shape: int, dtype, device=None) -> nn.Parameter:
    """A zero-filled parameter, created without ``requires_grad``: a
    training step turns it on for its own backward
    (``training/train.py::value_and_grad``)."""
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device),
                        requires_grad=False)


def shallow_copy(m: nn.Module) -> nn.Module:
    """A copy of the module tree that shares every tensor and owns its own
    parameter, buffer and child tables, so replacing an entry leaves ``m``
    as it was (``quant.quantize_params``, ``transformer.shard_params``)."""
    new = copy.copy(m)
    new._parameters = dict(m._parameters)
    new._buffers = dict(m._buffers)
    new._modules = {k: None if c is None else shallow_copy(c)
                    for k, c in m._modules.items()}
    return new


def resolve_device(device, what: str) -> torch.device:
    """``device``, or the card when None.  With no card and no ``device``
    it raises rather than run on the CPU unasked: the port's entry points
    run on CUDA unless the caller passes ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{what} runs on CUDA and no CUDA device is available; pass "
                "device='cpu' to run on the CPU")
        device = "cuda"
    return torch.device(device)


def use_f32_accumulation():
    """Make CUDA products accumulate as the reference's XLA dots do: f32
    products in full f32 (no TF32) and bf16 products reduced in f32.  These
    are process-wide torch flags; ``InferenceEngine`` sets them when it is
    built on a CUDA device, and a script that holds plain versions to the
    kernels before building an engine calls this first."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """Zero-centred RMSNorm (weight = 1 + scale), computed in f32."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (..., S) -> cos/sin (..., S, head_dim//2), f32.  No
    host-to-device copy (theta is filled on the device), so a captured
    decode step can run it."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freqs = torch.pow(torch.full((), theta, dtype=torch.float32,
                                 device=positions.device), exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Half-split rotation. x (..., S, H, D); cos/sin (..., S, 1, D/2)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as the reference computes it, ``logaddexp(x, 0)``
    (torch's ``F.softplus`` switches to x above a threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


ACTIVATIONS = {
    "swiglu": F.silu,
    "geglu": gelu,
    "gelu": gelu,
}
