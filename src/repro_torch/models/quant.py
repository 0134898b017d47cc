"""Per-row scaled int8/fp8 storage for serving (PyTorch): the paged KV
block pools and the serving weights.

Mirrors ``repro/models/quant.py``.  Both consumers share one scheme: a row
(the trailing dim) is stored as int8 or float8_e4m3fn plus one float32
scale ``amax(row) / qmax``.

* **KV block pools** (``cache_quant``): a cache row is one (slot, kv-head)
  pair, ``head_dim`` wide.  The scales live beside the pool
  (``attention.KVPool.k_scale`` / ``.v_scale``); the paged decode kernel
  folds them into its softmax instead of materialising the dequantized
  pool.
* **Serving weights** (``weight_quant``): ``quantize_params`` returns a
  model whose matmul weights (attention, MLP and expert projections and the
  untied ``lm_head``) are ``QTensor`` modules, dequantized at the matmul
  call sites through ``cast``, as the reference's ``QTensor.astype`` is.
  The caller's model is left as it was: the new one shares its other
  tensors.  A quantized model serves only: training and the checkpoint
  writer refuse it (``refuse_quantized``), as nothing in the reference
  trains one either.

Quantizing a zero row gives ``(0, scale=0)`` and dequantizing with a zero
scale gives zeros, so a reset block and a quantized scatter of zeros agree.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

# largest magnitude per storage format: int8 symmetric (+-127, -128 unused),
# float8 e4m3fn (+-448, the largest normal)
QMAX = {"int8": 127.0, "fp8": 448.0}
CACHE_QUANTS = (None, "int8", "fp8")


def qdtype(quant: str) -> torch.dtype:
    """Storage dtype for a quantization mode name."""
    if quant == "int8":
        return torch.int8
    if quant == "fp8":
        return torch.float8_e4m3fn
    raise ValueError(f"unknown quantization mode {quant!r}; "
                     f"expected one of {CACHE_QUANTS[1:]}")


def check_quant(quant):
    if quant not in CACHE_QUANTS:
        raise ValueError(f"unknown quantization mode {quant!r}; "
                         f"expected one of {CACHE_QUANTS}")
    return quant


def quant_of(dtype: torch.dtype) -> str:
    """The mode name of a quantized storage dtype."""
    return "int8" if dtype == torch.int8 else "fp8"


def quantize_rows(x: torch.Tensor, quant: str):
    """``x (..., D) -> (q (..., D), scale (...))``: symmetric per-row
    quantization with the scale over the trailing dim, in f32."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / QMAX[quant]
    y = xf / torch.where(scale > 0, scale, torch.ones_like(scale))[..., None]
    if quant == "int8":
        q = torch.round(y).clamp(-127.0, 127.0).to(torch.int8)
    else:
        q = y.to(torch.float8_e4m3fn)
    return q, scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    """Materialised per-row dequant, ``(q.float() * scale).to(dtype)`` as
    the reference computes it: the gathered-view oracle of the pools
    (``attention.paged_view``; the kernel applies the scales inside its
    softmax instead) and every ``QTensor`` weight.

    One product that reads the payload and writes ``dtype``: the f32
    product is rounded once on the store, so no f32 copy of the weight is
    written.  fp8 does not promote with f32 in torch; its values convert
    exactly to bf16 first."""
    if q.dtype != torch.int8:
        q = q.to(torch.bfloat16 if dtype == torch.bfloat16
                 else torch.float32)
    out = torch.empty(q.shape, dtype=dtype, device=q.device)
    return torch.mul(q, scale[..., None], out=out)


# ---------------------------------------------------------------------------
# weight storage
# ---------------------------------------------------------------------------

class QTensor(nn.Module):
    """A quantized weight: payload ``q`` (int8 / float8_e4m3fn) and a
    per-row f32 ``scale`` over the trailing dim, both buffers, so
    ``.to(device)`` moves them and ``state_dict`` lists them.

    It is not a tensor: ``cast`` (or ``dequantize``) gives the weight in a
    compute dtype.  Casting the module itself (``.to(dtype)``,
    ``.float()``) would rewrite its storage and raises instead."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    @property
    def ndim(self) -> int:
        return self.q.ndim

    def dequantize(self, dtype: torch.dtype) -> torch.Tensor:
        """The reference's ``QTensor.astype``."""
        return dequantize_rows(self.q, self.scale, dtype)

    def take_rows(self, idx: torch.Tensor, dtype: torch.dtype
                  ) -> torch.Tensor:
        """Rows ``idx`` of the leading dim, gathered quantized (payload and
        scale) and dequantized after the gather: k/E of an expert stack's
        bytes for the MoE gather decode."""
        return dequantize_rows(self.q[idx], self.scale[idx], dtype)

    def _apply(self, fn, recurse=True):
        q, scale = fn(self.q), fn(self.scale)
        if q.dtype != self.q.dtype or scale.dtype != self.scale.dtype:
            raise TypeError(
                "a QTensor keeps its int8/fp8 payload and f32 scales: move "
                "it with .to(device) and dequantize with quant.cast(w, "
                "dtype), never cast the module")
        self._buffers["q"], self._buffers["scale"] = q, scale
        return self

    def extra_repr(self) -> str:
        return f"q={tuple(self.q.shape)} {self.q.dtype}"


def cast(w, dtype: torch.dtype) -> torch.Tensor:
    """A matmul weight in ``dtype``: a tensor cast, a ``QTensor``
    dequantized (the reference's ``p["w"].astype(dt)`` at every call
    site)."""
    if isinstance(w, QTensor):
        return w.dequantize(dtype)
    return w.to(dtype)


def quantize_tensor(w: torch.Tensor, quant: str) -> QTensor:
    return QTensor(*quantize_rows(w.detach(), quant))


# matmul weights worth quantizing, the reference's set.  Left out as there:
# embeddings, norms and biases (small and numerically load-bearing), router
# logits (a routing flip is a different expert), and every recurrent-mixer
# weight (the RG-LRU and SSD recurrences compound a per-step error)
_QUANT_KEYS = frozenset({
    "wq", "wk", "wv", "wo",                  # attention projections
    "w_up", "w_down", "w_gate",              # dense and expert MLPs
    "lm_head",                               # untied output head
})


def _shallow(m: nn.Module) -> nn.Module:
    """A copy of the module tree that shares every tensor and owns its own
    parameter, buffer and child tables, so replacing an entry leaves ``m``
    as it was."""
    new = copy.copy(m)
    new._parameters = dict(m._parameters)
    new._buffers = dict(m._buffers)
    new._modules = {k: None if c is None else _shallow(c)
                    for k, c in m._modules.items()}
    return new


def quantize_params(model: nn.Module, quant: str) -> nn.Module:
    """A new model whose parameters named in ``_QUANT_KEYS``, wherever they
    sit in the tree (a hybrid's local-attention projections, an MoE's
    expert stacks and shared expert, the untied head), are ``QTensor``s of
    ``quant``; every other tensor is shared with ``model``, which is not
    changed."""
    check_quant(quant)
    if quant is None:
        raise ValueError("quantize_params needs 'int8' or 'fp8'")
    out = _shallow(model)
    for mod in out.modules():
        if isinstance(mod, QTensor):
            continue
        for name in [n for n, p in mod._parameters.items()
                     if n in _QUANT_KEYS and p is not None]:
            w = mod._parameters.pop(name)
            mod._modules[name] = quantize_tensor(w, quant)
    return out


def dequantize_params(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """A new model holding each ``QTensor`` of ``model`` as a frozen
    parameter of its dequantized values in ``dtype`` (what every matmul of
    the quantized model multiplies by), the other tensors shared: the
    quantized model's unquantized twin."""
    out = _shallow(model)
    for mod in out.modules():
        for name in [n for n, c in mod._modules.items()
                     if isinstance(c, QTensor)]:
            w = mod._modules.pop(name).dequantize(dtype)
            mod._parameters[name] = nn.Parameter(w, requires_grad=False)
    return out


def quantized_names(model: nn.Module) -> list[str]:
    """Dotted names of the model's ``QTensor`` weights."""
    return [n for n, m in model.named_modules() if isinstance(m, QTensor)]


def refuse_quantized(model: nn.Module, what: str) -> None:
    """Raise for a model that holds ``QTensor`` weights: ``what`` (a
    training step, a checkpoint) needs every weight as a parameter."""
    names = quantized_names(model)
    if names:
        raise TypeError(
            f"{what} takes an unquantized model; this one holds "
            f"{len(names)} QTensor weights ({names[0]}, ...): quantized "
            "weights (weight_quant) are for serving only")
