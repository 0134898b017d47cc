"""LoRA adapters (QLoRA-style efficient fine-tuning, paper Sec. II/IV-H),
PyTorch port of ``repro/models/lora.py``.

Adapters target the attention q/v projections and the MLP up-projection
(``wq``, ``wv``, ``w_up``).  The adapter tree maps a parameter name of the
model to ``{"a": (D_in, r), "b": (r, *W_out)}``; the reference's tree is
nested like its stacked parameter tree, and ``convert.from_jax_lora``
unstacks it into this one.  ``merge`` gives the effective parameters W' =
W + scale * A.B (the base detached when ``freeze_base``) by parameter name,
for ``torch.func.functional_call``: a loss differentiated with respect to
the adapters trains only them.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import quant as Q

# leaf name -> number of trailing dims that form the weight (in, out...) block
_TARGETS = {"wq": 3, "wv": 3, "w_up": 2}


def lora_defs(params: nn.Module, rank: int = 8) -> dict:
    """{name: {"a": shape, "b": shape}} for every adapted parameter of
    ``params``."""
    Q.refuse_quantized(params, "LoRA")
    out = {}
    for name, p in params.named_parameters():
        nd = _TARGETS.get(name.rsplit(".", 1)[-1])
        if nd is None or p.ndim < nd:
            continue
        lead = tuple(p.shape[:p.ndim - nd])
        win, wout = p.shape[p.ndim - nd], tuple(p.shape[p.ndim - nd + 1:])
        out[name] = {"a": lead + (win, rank), "b": lead + (rank,) + wout}
    return out


def init_lora(params: nn.Module, generator: torch.Generator, rank: int = 8,
              dtype=torch.float32) -> dict:
    """A drawn from normal(0.02) in f32 then cast, B zeros, on the
    parameters' device; the numbers differ from JAX's for the same seed
    (tests convert JAX's adapters instead)."""
    dev = next(params.parameters()).device
    out = {}
    for name, shapes in lora_defs(params, rank).items():
        a = torch.randn(shapes["a"], generator=generator,
                        device=generator.device) * 0.02
        out[name] = {"a": a.to(device=dev, dtype=dtype),
                     "b": torch.zeros(shapes["b"], dtype=dtype, device=dev)}
    return out


def _delta(a: torch.Tensor, b: torch.Tensor, base_nd: int) -> torch.Tensor:
    if base_nd == 2:
        return torch.einsum("...ir,...ro->...io", a, b)
    return torch.einsum("...ir,...rho->...iho", a, b)


def merge(params: nn.Module, lora: dict, scale: float = 1.0,
          freeze_base: bool = True) -> dict:
    """Effective parameters by name: W + scale * A.B on adapted leaves (in
    f32, cast back to W's dtype), W elsewhere, every base W detached when
    ``freeze_base``."""
    Q.refuse_quantized(params, "a LoRA merge")
    out = {}
    for name, w in params.named_parameters():
        base = w.detach() if freeze_base else w
        ad = lora.get(name)
        if ad is not None:
            d = _delta(ad["a"], ad["b"], _TARGETS[name.rsplit(".", 1)[-1]])
            base = (base.float() + scale * d.float()).to(w.dtype)
        out[name] = base
    return out
